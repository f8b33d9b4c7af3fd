// Fused polar retraction  R_x(P_x(g)) = (x + u)(I + u^T u)^{-1/2},
// u = g - x sym(x^T g), node-batched.
//
// Replaces: src/repro/kernels/retract.py, fused_retract_2d
// (_fused_kernel with _ns_invsqrt; one two-pass pallas_call per leaf).
//
// Same algebra as the TPU kernel.  Because x^T x = I, every (r, r)
// statistic of u follows from two Grams of the inputs:
//   B = x^T g,  C = g^T g,  S = sym(B),  u^T u = C - B^T S - S B + S S,
//   out = x M1 + g M2,  M2 = inv = (I + u^T u)^{-1/2},  M1 = (I - S) inv,
// with inv from the coupled Newton--Schulz iteration (inf-norm scaling,
// ns_iters iterations, as geometry/stiefel.py does).  The TPU wrapper pads
// r to the 128-lane boundary and takes any r; so does this one.
//
// Bound on the H100: operations.  At the fair fc1 shape (20, 784, 64) one
// call is 2 x 2 d r^2 flops of Grams plus 2 x 2 d r^2 of apply per node and
// ns_iters x 3 products of 2 r^3 flops; 12 MB of unique bytes.  The
// Newton--Schulz chain is sequential: 63 dependent (r, r) products per
// node, each too small to fill an SM at small r, so latency bounds the
// stage there; at r = 576 (smollm-135m's wq / wo) the chain's 22.9 GFLOP a
// node are the work.
//
// Design: the Grams and the apply are launches of their own; the (r, r)
// stage between them takes one of three routes by r.
//   1. The Grams B and C: gram_kernel<kGramTwo> (tall.cuh) on the tensor
//      cores as 3xTF32, the d reduction added inside a cluster per tile.
//   2. The (r, r) stage, from B and C to M1 and M2:
//      * r <= kSmallR (32; the head leaf has r = 3): finalize_small_kernel,
//        one block per node, one thread per matrix element, the six (r, r)
//        matrices in shared memory (a single warp at r <= 5).
//      * 32 < r <= kMaxR (256): a thread block cluster of CS CTAs per
//        node (4 for r <= 64, 8 above).  The r x r matrices are padded
//        with zeros to RP = CS * P rows and columns, and CTA `rank`
//        computes rows [rank P, rank P + P) of every product, from its own
//        rows of A and all of B.  cluster.sync() separates dependent
//        products; Y T and T Z, which read only the T of the stage before,
//        share one: 2 cluster barriers per Newton--Schulz iteration.
//        - r <= 64, finalize_full_kernel: each CTA holds whole copies of
//          the six matrices (96 KB), so a product reads only its own
//          shared memory; its result rows go to every CTA's copy as
//          distributed-shared-memory stores (map_shared_rank) ahead of the
//          barrier.  After the last iteration the CTAs work alone.
//        - r > 64, finalize_cluster_kernel: each CTA keeps row panels
//          (P, RP) of the six, and a product walks B's row panels, its own
//          first, then each peer's, copied once through distributed shared
//          memory into a staging panel while the panel before it is
//          multiplied.  Seven panels fit in 227 KB up to r = 256 (P = 32,
//          CS = 8: 229,376 bytes), so no matrix goes to global memory.
//        Products are register-tiled fp32 FMA (TR x TC outputs a thread,
//        compile-time bounds, float4 shared-memory loads, no bounds
//        checks: the padding is zeros), summed over k in one fixed order
//        per CTA.
//      * r > kMaxR: the global route (namespace glob).  At r = 576 the
//        seven fp32 (r, r) matrices of a node are 9.3 MB, far over a
//        cluster's shared memory, but a node's working set stays in the
//        50 MB L2.  Every (r, r) product is a node-batched tiled GEMM on
//        the tensor cores as 3xTF32 (ns_mm_kernel: tall.cuh's 64 x 64 block
//        tile, cp.async staging and per-k-step partials, mma_tile), the
//        elementwise steps are small kernels of their own, and the launch
//        boundaries are the barriers; every product that is symmetric in
//        exact arithmetic (S S and the Newton--Schulz products: Y, Z and
//        T are polynomials in A) computes only its tiles on and above the
//        diagonal and stores each off-diagonal one at its mirror too (45
//        of 81 tiles at r = 576).  Launches: sym (S, B^T); mm {B^T S, S S};
//        form_a (A = I + u^T u and its row sums); scale (c, Y_0 = A / c,
//        Z_0 = I); per iteration mm {T = (3 I - Z Y) / 2} and mm {Y T,
//        T Z} (they read only the T before them, so they share one
//        launch); finish (M2 = Z / sqrt(c), I - S); mm {M1}.  That is
//        2 ns_iters + 6 launches, 48 a call with the Grams and the apply
//        at ns_iters = 20.  No atomics: c is the max of the row sums,
//        which every scale block takes over the same r values.
//   3. out = x M1 + g M2: apply_kernel<kApplyRetract> (tall.cuh, 3xTF32).
// The cluster routes' (r, r) stage is fp32 FMA on CUDA cores; every other
// product is 3xTF32, fp32-accurate: plain TF32 breaks the 5e-5 gate, and
// so does accumulating in the mma over a whole reduction (tall.cuh).
#include <cooperative_groups.h>

#include <initializer_list>

#include "tall.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxSmem = 232448;  // bytes of shared memory a block may use
constexpr int kSmallR = 32;       // r <= kSmallR: one block per node
constexpr int kMaxR = 256;        // retract.py's MAX_R: the cluster
                                  // routes' edge; above, the global one

// ---------------------------------------------------------------------------
// r <= kSmallR: one block per node, one thread per element
// ---------------------------------------------------------------------------

// c[e] = sum_k a[i, k] b[k, j] for this thread's element e = i r + j.
__device__ __forceinline__ float small_mm(const float* a, const float* b,
                                          int i, int j, int r) {
  float acc = 0.f;
  for (int k = 0; k < r; ++k) acc = fmaf(a[i * r + k], b[k * r + j], acc);
  return acc;
}

__global__ void __launch_bounds__(1024)
finalize_small_kernel(const float* __restrict__ pb,
                      const float* __restrict__ pc, float* __restrict__ m1,
                      float* __restrict__ m2, int r, int ns_iters) {
  extern __shared__ float sm[];
  __shared__ float red;
  const int b = blockIdx.x, e = threadIdx.x, rr = r * r;
  const bool live = e < rr;
  const int i = live ? e / r : 0, j = live ? e % r : 0;
  const float eye = i == j ? 1.f : 0.f;
  float* s = sm;            // S
  float* bt = sm + rr;      // B^T, then Z
  float* a = sm + 2 * rr;   // C, then A = I + u^T u, then Y
  float* t = sm + 3 * rr;   // B^T S, then T
  float* u = sm + 4 * rr;   // S S, then Y_new
  float* v = sm + 5 * rr;   // Z_new

  if (live) {
    const float* pbb = pb + (size_t)b * rr;
    const float sbt = pbb[j * r + i];
    s[e] = 0.5f * (pbb[e] + sbt);
    bt[e] = sbt;
    a[e] = pc[(size_t)b * rr + e];
  }
  __syncthreads();
  if (live) {
    t[e] = small_mm(bt, s, i, j, r);   // B^T S
    u[e] = small_mm(s, s, i, j, r);    // S S
  }
  __syncthreads();
  // A = I + u^T u,  u^T u = C - B^T S - (B^T S)^T + S S
  if (live) a[e] = eye + (((a[e] - t[e]) - t[j * r + i]) + u[e]);
  __syncthreads();
  // c = max_i sum_j |A_ij| + 1e-6: rows i < r <= 32 in warp 0
  if (e < 32) {
    float acc = 0.f;
    if (e < r)
      for (int k = 0; k < r; ++k) acc += fabsf(a[e * r + k]);
    for (int o = 16; o > 0; o >>= 1)
      acc = fmaxf(acc, __shfl_xor_sync(0xffffffffu, acc, o));
    if (e == 0) red = acc;
  }
  __syncthreads();
  const float c = red + 1e-6f;
  if (live) {
    a[e] = a[e] / c;   // Y_0 = A / c
    bt[e] = eye;       // Z_0 = I
  }
  __syncthreads();
  float* y = a;
  float* z = bt;
  for (int it = 0; it < ns_iters; ++it) {
    if (live) t[e] = 0.5f * (3.f * eye - small_mm(z, y, i, j, r));
    __syncthreads();
    if (live) {
      u[e] = small_mm(y, t, i, j, r);   // Y_new = Y T
      v[e] = small_mm(t, z, i, j, r);   // Z_new = T Z
    }
    __syncthreads();
    float* tmp = y; y = u; u = tmp;
    tmp = z; z = v; v = tmp;
  }
  // inv = Z / sqrt(c);  M2 = inv;  M1 = (I - S) inv
  const float rs = 1.f / sqrtf(c);
  if (live) {
    const float inv = z[e] * rs;
    u[e] = inv;
    m2[(size_t)b * rr + e] = inv;
    t[e] = eye - s[e];
  }
  __syncthreads();
  if (live) m1[(size_t)b * rr + e] = small_mm(t, u, i, j, r);
}

// ---------------------------------------------------------------------------
// 32 < r <= kMaxR: a cluster of CS CTAs per node
// ---------------------------------------------------------------------------

// CS CTAs a node, P padded rows a CTA, TR x TC outputs a thread; FULL: each
// CTA holds whole (RP, RP) copies of the six matrices, else (P, RP) row
// panels and G staging panels (as many of the CS - 1 peers' panels as fit
// beside the six).  Thread (rg, cg) owns rows rg + p NRG (p < TR) and the
// float4 column chunks cg + q NCG (q < TC / 4).  NCG >= 8, so the 8
// threads of each quarter warp share their rows: A's float4 reads are
// broadcasts, B's are consecutive, and no padding of the rows is needed
// against bank conflicts.  Each B element is read once per row group
// (NRG = P / TR times), so a larger TR moves fewer shared-memory bytes
// but leaves fewer warps to hide latency.
template <int CS_, int P_, int TR_, int TC_, bool FULL_>
struct Cfg {
  static constexpr int CS = CS_, P = P_, TR = TR_, TC = TC_;
  static constexpr bool kFull = FULL_;
  static constexpr int RP = CS * P;           // padded order of the matrices
  static constexpr int NCG = RP / TC, NRG = P / TR;
  static constexpr int kThreads = NCG * NRG;
  static constexpr int kPanel = P * RP;       // floats of one row panel
  static constexpr int kVec = kPanel / 4 / kThreads;  // float4 a thread
  static constexpr int kMat = FULL_ ? RP * RP : kPanel;  // floats a buffer
  static constexpr int kRoom = (kMaxSmem / 4 - 6 * kMat - 4) / kPanel;
  static constexpr int G = FULL_ ? 0 : (kRoom < CS - 1 ? kRoom : CS - 1);
  // six matrices (whole or a panel each), G staging panels, the row maxima
  static constexpr size_t kSmem =
      (6 * (size_t)kMat + (size_t)G * kPanel + 4) * sizeof(float);
  static_assert(NCG >= 8 && kThreads <= 1024 && kVec * 4 * kThreads == kPanel,
                "tile");
  static_assert(kSmem <= (size_t)kMaxSmem && (FULL_ || G >= 1),
                "shared memory");
};
// Chosen by measurement (launch/kernel_variants.py on an NVIDIA H100 80GB
// HBM3 at 700 W: the (r, r) stage's device time, 20 nodes, ns_iters = 20):
// r = 64 on 4 CTAs of 128 threads, 2 x 4 outputs each, 101.8 us, against
// 122.2 (1 x 4), 125.6 (4 x 4), 123.4 (2 CTAs, 4 x 4), 123.3 (8 CTAs,
// 2 x 4) and 146.6 (8 CTAs, 1 x 4); r = 99 with 4 x 4 outputs 483.5 us
// against 665.7 with 2 x 4; r = 256 with 8 x 4 outputs 2202.4 us against
// 2316.8 with 4 x 8.
using Cfg64 = Cfg<4, 16, 2, 4, true>;     // r <= 64: 128 threads, 96 KB
using Cfg128 = Cfg<8, 16, 4, 4, false>;   // r <= 128: 128 threads, G = 7
using Cfg256 = Cfg<8, 32, 8, 4, false>;   // r <= 256: 256 threads, G = 1

// acc += (own rows of A)[:, k0 : k0 + P] panel, panel = rows k0.. of B.
template <class C>
__device__ __forceinline__ void panel_fma(const float* a, const float* panel,
                                          int k0, float (&acc)[C::TR][C::TC]) {
  const int rg = threadIdx.x / C::NCG, cg = threadIdx.x % C::NCG;
#pragma unroll 2
  for (int kk = 0; kk < C::P; kk += 4) {
    float4 av[C::TR];
#pragma unroll
    for (int p = 0; p < C::TR; ++p)
      av[p] = *reinterpret_cast<const float4*>(
          a + (rg + p * C::NRG) * C::RP + k0 + kk);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float4 bv[C::TC / 4];
#pragma unroll
      for (int q = 0; q < C::TC / 4; ++q)
        bv[q] = *reinterpret_cast<const float4*>(
            panel + (kk + e) * C::RP + 4 * (cg + q * C::NCG));
#pragma unroll
      for (int p = 0; p < C::TR; ++p) {
        const float x = e == 0 ? av[p].x : e == 1 ? av[p].y
                      : e == 2 ? av[p].z : av[p].w;
#pragma unroll
        for (int q = 0; q < C::TC / 4; ++q) {
          acc[p][4 * q] = fmaf(x, bv[q].x, acc[p][4 * q]);
          acc[p][4 * q + 1] = fmaf(x, bv[q].y, acc[p][4 * q + 1]);
          acc[p][4 * q + 2] = fmaf(x, bv[q].z, acc[p][4 * q + 2]);
          acc[p][4 * q + 3] = fmaf(x, bv[q].w, acc[p][4 * q + 3]);
        }
      }
    }
  }
}

template <class C>
__device__ __forceinline__ void zero(float (&acc)[C::TR][C::TC]) {
#pragma unroll
  for (int p = 0; p < C::TR; ++p)
#pragma unroll
    for (int q = 0; q < C::TC; ++q) acc[p][q] = 0.f;
}

// acc = (own rows of A) B with B whole in this CTA's shared memory; the k
// panels in the order rank, rank + 1, ... as in cluster_mm.
template <class C>
__device__ __forceinline__ void local_mm(const float* a, const float* b,
                                         int rank,
                                         float (&acc)[C::TR][C::TC]) {
  zero<C>(acc);
#pragma unroll 1
  for (int i = 0; i < C::CS; ++i) {
    const int s = (rank + i) % C::CS;
    panel_fma<C>(a, b + s * C::kPanel, s * C::P, acc);
  }
}

// acc = (own rows of A) B, B's row panels in buffer `bb` of every CTA of
// the cluster (the caller's cluster.sync made them ready).  Panels in the
// order rank, rank + 1, ...: the own one from place, the peers' G at a
// time, copied into `stage` (their loads issued before the panels ahead
// are multiplied, all G in flight together).
template <class C>
__device__ void cluster_mm(cg::cluster_group& cluster, const float* a,
                           float* bb, float* stage, int rank,
                           float (&acc)[C::TR][C::TC]) {
  constexpr int G = C::G;
  zero<C>(acc);
  float4 pre[G][C::kVec];
  auto fetch = [&](int i0) {
#pragma unroll
    for (int g = 0; g < G; ++g)
      if (i0 + g < C::CS) {
        const float4* src = reinterpret_cast<const float4*>(
            cluster.map_shared_rank(bb, (rank + i0 + g) % C::CS));
#pragma unroll
        for (int v = 0; v < C::kVec; ++v)
          pre[g][v] = src[threadIdx.x + v * C::kThreads];
      }
  };
  fetch(1);
  panel_fma<C>(a, bb, rank * C::P, acc);
#pragma unroll 1
  for (int i0 = 1; i0 < C::CS; i0 += G) {
    __syncthreads();   // the staging panels are free
#pragma unroll
    for (int g = 0; g < G; ++g)
      if (i0 + g < C::CS) {
#pragma unroll
        for (int v = 0; v < C::kVec; ++v)
          reinterpret_cast<float4*>(stage + g * C::kPanel)[
              threadIdx.x + v * C::kThreads] = pre[g][v];
      }
    __syncthreads();
    if (i0 + G < C::CS) fetch(i0 + G);
#pragma unroll
    for (int g = 0; g < G; ++g)
      if (i0 + g < C::CS)
        panel_fma<C>(a, stage + g * C::kPanel,
                     ((rank + i0 + g) % C::CS) * C::P, acc);
  }
}

// Calls f(local row, global row, first column, 4 values) for each of the
// thread's float4 chunks of outputs.
template <class C, class F>
__device__ __forceinline__ void each_out(int row0,
                                         const float (&acc)[C::TR][C::TC],
                                         F f) {
  const int rg = threadIdx.x / C::NCG, cg = threadIdx.x % C::NCG;
#pragma unroll
  for (int p = 0; p < C::TR; ++p)
#pragma unroll
    for (int q = 0; q < C::TC / 4; ++q) {
      const int il = rg + p * C::NRG;
      f(il, row0 + il, 4 * (cg + q * C::NCG),
        make_float4(acc[p][4 * q], acc[p][4 * q + 1], acc[p][4 * q + 2],
                    acc[p][4 * q + 3]));
    }
}

// T = 0.5 (3 I - x) on the 4 columns j0.. of row i (I only for i < r).
__device__ __forceinline__ float4 ns_t(float4 x, int i, int j0, int r) {
  auto one = [&](float v, int j) {
    return 0.5f * ((i == j && i < r ? 3.f : 0.f) - v);
  };
  return make_float4(one(x.x, j0), one(x.y, j0 + 1), one(x.z, j0 + 2),
                     one(x.w, j0 + 3));
}

// Row il of the own panel of matrix `buf`, columns j0..j0 + 3: in place
// (panel route) or, FULL, at the own rows of every CTA's whole copy.
template <class C>
__device__ __forceinline__ void put(cg::cluster_group& cluster, float* buf,
                                    int row0, int il, int j0, float4 v) {
  if constexpr (C::kFull) {
#pragma unroll
    for (int q = 0; q < C::CS; ++q)
      *reinterpret_cast<float4*>(cluster.map_shared_rank(buf, q) +
                                 (row0 + il) * C::RP + j0) = v;
  } else {
    *reinterpret_cast<float4*>(buf + il * C::RP + j0) = v;
  }
}

// r <= 64 (FULL): every CTA keeps whole copies, so a product reads only
// its own shared memory, and its result rows go to every CTA's copy
// (distributed-shared-memory stores) before the cluster barrier.
template <class C>
__global__ void __launch_bounds__(C::kThreads, 1)
finalize_full_kernel(const float* __restrict__ pb,
                     const float* __restrict__ pc, float* __restrict__ m1,
                     float* __restrict__ m2, int r, int ns_iters) {
  static_assert(C::kFull, "whole copies");
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int b = blockIdx.x / C::CS;
  const int row0 = rank * C::P;
  const int tid = threadIdx.x;
  constexpr int RP = C::RP, kMat = C::kMat;
  const size_t rr = (size_t)r * r;
  float* s = sm;                 // S (whole)
  float* z = sm + kMat;          // own rows of B^T, then Z
  float* y = sm + 2 * kMat;      // own rows of C, then A, then Y
  float* t = sm + 3 * kMat;      // B^T S, then T, then inv
  float* yn = sm + 4 * kMat;     // own rows of S S, then Y_new
  float* zn = sm + 5 * kMat;     // B (whole), then Z_new
  float* red = sm + 6 * kMat;
  float acc[C::TR][C::TC];
  cluster.sync();   // every CTA has started: its shared memory may be written

  // own rows of B (to every CTA) and of C; zeros in the padding
  {
    const float* pbb = pb + (size_t)b * rr;
    const float* pcb = pc + (size_t)b * rr;
    for (int e4 = tid; e4 < C::kPanel / 4; e4 += C::kThreads) {
      const int il = 4 * e4 / RP, j0 = 4 * e4 % RP, i = row0 + il;
      float vb[4], vc[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int j = j0 + q;
        const bool in = i < r && j < r;
        vb[q] = in ? pbb[(size_t)i * r + j] : 0.f;
        vc[q] = in ? pcb[(size_t)i * r + j] : 0.f;
      }
      put<C>(cluster, zn, row0, il, j0, make_float4(vb[0], vb[1], vb[2], vb[3]));
      *reinterpret_cast<float4*>(y + i * RP + j0) =
          make_float4(vc[0], vc[1], vc[2], vc[3]);
    }
  }
  cluster.sync();
  // S = sym(B) whole, B^T's own rows
  for (int e = tid; e < kMat; e += C::kThreads) {
    const int i = e / RP, j = e % RP;
    s[e] = 0.5f * (zn[e] + zn[j * RP + i]);
  }
  for (int e = tid; e < C::kPanel; e += C::kThreads) {
    const int il = e / RP, k = e % RP;
    z[(row0 + il) * RP + k] = zn[k * RP + row0 + il];
  }
  __syncthreads();
  local_mm<C>(z + row0 * RP, s, rank, acc);          // B^T S, to every CTA
  each_out<C>(row0, acc, [&](int il, int, int j0, float4 v) {
    put<C>(cluster, t, row0, il, j0, v);
  });
  local_mm<C>(s + row0 * RP, s, rank, acc);          // S S, own rows
  each_out<C>(row0, acc, [&](int il, int i, int j0, float4 v) {
    *reinterpret_cast<float4*>(yn + i * RP + j0) = v;
  });
  cluster.sync();
  // A = I + u^T u (own rows, to every CTA),
  // u^T u = C - B^T S - (B^T S)^T + S S
  for (int e4 = tid; e4 < C::kPanel / 4; e4 += C::kThreads) {
    const int il = 4 * e4 / RP, j0 = 4 * e4 % RP, i = row0 + il;
    float v[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int j = j0 + q, e = i * RP + j;
      v[q] = i < r && j < r
                 ? (i == j ? 1.f : 0.f) +
                       (((y[e] - t[e]) - t[j * RP + i]) + yn[e])
                 : 0.f;
    }
    put<C>(cluster, y, row0, il, j0, make_float4(v[0], v[1], v[2], v[3]));
  }
  cluster.sync();
  // c = max_i sum_j |A_ij| + 1e-6 over the whole A, the same in every CTA
  if (tid < 32) {
    float m = 0.f;
    for (int i = tid; i < r; i += 32) {
      float acc_row = 0.f;
      for (int j = 0; j < r; ++j) acc_row += fabsf(y[i * RP + j]);
      m = fmaxf(m, acc_row);
    }
    for (int o = 16; o > 0; o >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    if (tid == 0) red[0] = m;
  }
  __syncthreads();
  const float c = red[0] + 1e-6f;
  for (int e = tid; e < kMat; e += C::kThreads) {
    const int i = e / RP, j = e % RP;
    y[e] = y[e] / c;                          // Y_0 = A / c
    z[e] = i == j && i < r ? 1.f : 0.f;       // Z_0 = I
  }
  __syncthreads();
  for (int it = 0; it < ns_iters; ++it) {
    local_mm<C>(z + row0 * RP, y, rank, acc);                // Z Y
    each_out<C>(row0, acc, [&](int il, int i, int j0, float4 v) {
      put<C>(cluster, t, row0, il, j0, ns_t(v, i, j0, r));
    });
    cluster.sync();
    local_mm<C>(y + row0 * RP, t, rank, acc);                // Y T
    each_out<C>(row0, acc, [&](int il, int, int j0, float4 v) {
      put<C>(cluster, yn, row0, il, j0, v);
    });
    local_mm<C>(t + row0 * RP, z, rank, acc);                // T Z
    each_out<C>(row0, acc, [&](int il, int, int j0, float4 v) {
      put<C>(cluster, zn, row0, il, j0, v);
    });
    cluster.sync();
    float* tmp = y; y = yn; yn = tmp;
    tmp = z; z = zn; zn = tmp;
  }
  // inv = Z / sqrt(c) (whole, in t);  M2 = inv;  M1 = (I - S) inv: no
  // more traffic between the CTAs
  const float rs = 1.f / sqrtf(c);
  float* m1b = m1 + (size_t)b * rr;
  float* m2b = m2 + (size_t)b * rr;
  for (int e = tid; e < kMat; e += C::kThreads) {
    const int i = e / RP, j = e % RP;
    const float inv = z[e] * rs;
    t[e] = inv;
    if (i >= row0 && i < row0 + C::P) {
      if (i < r && j < r) m2b[(size_t)i * r + j] = inv;
      yn[e] = (i == j && i < r ? 1.f : 0.f) - s[e];
    }
  }
  __syncthreads();
  local_mm<C>(yn + row0 * RP, t, rank, acc);
  each_out<C>(row0, acc, [&](int, int i, int j0, float4 v) {
    const float x[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (i < r && j0 + q < r) m1b[(size_t)i * r + j0 + q] = x[q];
  });
}

// r > 64: each CTA keeps (P, RP) row panels; a product streams its peers'
// panels of B through the staging panel.
template <class C>
__global__ void __launch_bounds__(C::kThreads, 1)
finalize_cluster_kernel(const float* __restrict__ pb,
                        const float* __restrict__ pc, float* __restrict__ m1,
                        float* __restrict__ m2, int r, int ns_iters) {
  static_assert(!C::kFull, "row panels");
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int b = blockIdx.x / C::CS;
  const int row0 = rank * C::P;
  const int tid = threadIdx.x;
  constexpr int RP = C::RP, kPanel = C::kPanel;
  float* s = sm;                  // S, kept to the end
  float* z = sm + kPanel;         // B^T, then Z
  float* y = sm + 2 * kPanel;     // C, then A, then Y
  float* t = sm + 3 * kPanel;     // B^T S, then T, then inv
  float* yn = sm + 4 * kPanel;    // S S, then Y_new
  float* zn = sm + 5 * kPanel;    // Z_new
  float* stage = sm + 6 * kPanel;
  float* red = stage + C::G * kPanel;
  const size_t rr = (size_t)r * r;
  float acc[C::TR][C::TC];

  // own rows of B (-> zn) and C (-> y); zeros in the padding
  {
    const float* pbb = pb + (size_t)b * rr;
    const float* pcb = pc + (size_t)b * rr;
    for (int e = tid; e < kPanel; e += C::kThreads) {
      const int i = row0 + e / RP, j = e % RP;
      const bool in = i < r && j < r;
      zn[e] = in ? pbb[(size_t)i * r + j] : 0.f;
      y[e] = in ? pcb[(size_t)i * r + j] : 0.f;
    }
  }
  cluster.sync();
  // own rows of B^T (-> z) and of S = sym(B): B^T's (i, k) element is B's
  // (k, i), in the panel of row k's CTA
  for (int e = tid; e < kPanel; e += C::kThreads) {
    const int i = row0 + e / RP, k = e % RP;
    const float bt = cluster.map_shared_rank(zn, k / C::P)[(k % C::P) * RP + i];
    z[e] = bt;
    s[e] = 0.5f * (zn[e] + bt);
  }
  cluster.sync();
  cluster_mm<C>(cluster, z, s, stage, rank, acc);   // B^T S
  each_out<C>(row0, acc, [&](int il, int, int j0, float4 v) {
    put<C>(cluster, t, row0, il, j0, v);
  });
  cluster_mm<C>(cluster, s, s, stage, rank, acc);   // S S
  each_out<C>(row0, acc, [&](int il, int, int j0, float4 v) {
    put<C>(cluster, yn, row0, il, j0, v);
  });
  cluster.sync();
  // A = I + u^T u,  u^T u = C - B^T S - (B^T S)^T + S S; the transpose's
  // (j, i) element lives in the panel of row j's CTA
  for (int e = tid; e < kPanel; e += C::kThreads) {
    const int i = row0 + e / RP, j = e % RP;
    float x = 0.f;
    if (i < r && j < r) {
      const float* tj = cluster.map_shared_rank(t, j / C::P);
      x = (i == j ? 1.f : 0.f) +
          (((y[e] - t[e]) - tj[(j % C::P) * RP + i]) + yn[e]);
    }
    y[e] = x;
  }
  __syncthreads();
  // c = max_i sum_j |A_ij| + 1e-6: the own rows' maximum, then the peers'
  if (tid < 32) {
    float m = 0.f;
    for (int il = tid; il < C::P; il += 32) {
      float acc_row = 0.f;
      for (int j = 0; j < r; ++j) acc_row += fabsf(y[il * RP + j]);
      m = fmaxf(m, acc_row);
    }
    for (int o = 16; o > 0; o >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    if (tid == 0) red[0] = m;
  }
  cluster.sync();
  float cmax = 0.f;
#pragma unroll
  for (int q = 0; q < C::CS; ++q)
    cmax = fmaxf(cmax, cluster.map_shared_rank(red, q)[0]);
  const float c = cmax + 1e-6f;
  for (int e = tid; e < kPanel; e += C::kThreads) {
    const int i = row0 + e / RP, j = e % RP;
    y[e] = y[e] / c;                          // Y_0 = A / c
    z[e] = i == j && i < r ? 1.f : 0.f;       // Z_0 = I
  }
  cluster.sync();
  for (int it = 0; it < ns_iters; ++it) {
    cluster_mm<C>(cluster, z, y, stage, rank, acc);        // Z Y
    each_out<C>(row0, acc, [&](int il, int i, int j0, float4 v) {
      put<C>(cluster, t, row0, il, j0, ns_t(v, i, j0, r));
    });
    cluster.sync();
    cluster_mm<C>(cluster, y, t, stage, rank, acc);        // Y T
    each_out<C>(row0, acc, [&](int il, int, int j0, float4 v) {
      put<C>(cluster, yn, row0, il, j0, v);
    });
    cluster_mm<C>(cluster, t, z, stage, rank, acc);        // T Z
    each_out<C>(row0, acc, [&](int il, int, int j0, float4 v) {
      put<C>(cluster, zn, row0, il, j0, v);
    });
    cluster.sync();
    float* tmp = y; y = yn; yn = tmp;
    tmp = z; z = zn; zn = tmp;
  }
  // inv = Z / sqrt(c) (in t);  M2 = inv;  M1 = (I - S) inv
  const float rs = 1.f / sqrtf(c);
  float* m1b = m1 + (size_t)b * rr;
  float* m2b = m2 + (size_t)b * rr;
  for (int e = tid; e < kPanel; e += C::kThreads) {
    const int i = row0 + e / RP, j = e % RP;
    const float inv = z[e] * rs;
    t[e] = inv;
    if (i < r && j < r) m2b[(size_t)i * r + j] = inv;
    yn[e] = (i == j && i < r ? 1.f : 0.f) - s[e];
  }
  cluster.sync();
  cluster_mm<C>(cluster, yn, t, stage, rank, acc);
  each_out<C>(row0, acc, [&](int, int i, int j0, float4 v) {
    const float x[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (i < r && j0 + q < r) m1b[(size_t)i * r + j0 + q] = x[q];
  });
  cluster.sync();   // no CTA leaves while a peer may still read its panels
}

// The (r, r) stage's kernel for 1 <= r <= kMaxR and its launch: one block
// a node of finalize_small_kernel up to kSmallR, else the first Cfg whose
// padded order covers r, on a cluster of CS CTAs a node.  The launch,
// repro_fused_retract_cluster and repro_fused_retract_resources all take
// it from here.
struct Stage {
  void (*kernel)(const float*, const float*, float*, float*, int, int);
  int threads;   // threads a block
  size_t smem;   // dynamic shared memory a block, bytes
  int cs;        // CTAs a node: 1 (one block, no cluster) or a cluster
};

template <class C, class K>
Stage cluster_stage(K kernel) {
  return {kernel, C::kThreads, C::kSmem, C::CS};
}

Stage stage_for(int r) {
  if (r <= kSmallR)
    return {finalize_small_kernel, (r * r + 31) / 32 * 32,
            6 * (size_t)r * r * sizeof(float), 1};
  if (r <= Cfg64::RP)
    return cluster_stage<Cfg64>(finalize_full_kernel<Cfg64>);
  if (r <= Cfg128::RP)
    return cluster_stage<Cfg128>(finalize_cluster_kernel<Cfg128>);
  return cluster_stage<Cfg256>(finalize_cluster_kernel<Cfg256>);
}

// Each cluster kernel opted in to its shared memory, once a process.
int allow_stage_smem() {
  static const int err = [] {
    for (int r : {Cfg64::RP, Cfg128::RP, Cfg256::RP}) {
      const Stage s = stage_for(r);
      const cudaError_t e = cudaFuncSetAttribute(
          s.kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          (int)s.smem);
      if (e != cudaSuccess) return (int)e;
    }
    return 0;
  }();
  return err;
}

int launch_finalize(const float* pb, const float* pc, float* m1, float* m2,
                    int batch, int r, int ns_iters, cudaStream_t st) {
  const Stage s = stage_for(r);
  if (s.cs > 1)
    if (const int err = allow_stage_smem()) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(s.cs * batch));
  cfg.blockDim = dim3((unsigned)s.threads);
  cfg.dynamicSmemBytes = s.smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = s.cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = s.cs > 1 ? 1 : 0;   // one block a node: no cluster
  return (int)cudaLaunchKernelEx(&cfg, s.kernel, pb, pc, m1, m2, r, ns_iters);
}

// ---------------------------------------------------------------------------
// r > kMaxR: the (r, r) stage in global memory
// ---------------------------------------------------------------------------
namespace glob {

constexpr int kEw = 256;        // threads of an elementwise block
constexpr int kEwBlocks = 64;   // elementwise blocks a node (grid-stride)
constexpr int kRowWarps = 8;    // rows of A a form_a block

// One product of a launch: c = a b of (batch, r, r) row-major matrices, or
// with ns_t the Newton--Schulz T = (3 I - a b) / 2.  With sym the product
// is symmetric in exact arithmetic (S S, and every Newton--Schulz product:
// Y, Z and T are polynomials in A, so they commute), and only the tiles on
// and above the diagonal are computed, each off-diagonal one stored at its
// mirror too: 45 of 81 tiles at r = 576.
struct Mm {
  const float* a;
  const float* b;
  float* c;
  int ns_t;
  int sym;
};
struct MmPair {
  Mm job[2];
};

// grid (tiles, batch, jobs), 128 threads: one 64 x 64 tile of one node's
// product, tall.cuh's apply tile (4 warps of 32 x 32, two cp.async stages
// of kBK = 32 along k, mma_tile's per-k-step partials) with A and B both
// (r, r).  Tile x of a job: row-major over all T x T tiles, or with sym
// over the pairs ti <= tj, row by row (blocks past them leave).
__global__ void __launch_bounds__(tall::kThreads)
ns_mm_kernel(MmPair jobs, int r, int vec) {
  using namespace tall;
  extern __shared__ __align__(16) float sm[];
  constexpr int kA = kTile * kLdA;
  constexpr int kStage = kA + kBK * kLd;
  const Mm job = blockIdx.z == 0 ? jobs.job[0] : jobs.job[1];
  const int T = ceil_div(r, kTile);
  int ti, tj;
  if (job.sym) {
    int x = blockIdx.x;
    if (x >= T * (T + 1) / 2) return;
    ti = 0;
    while (x >= T - ti) x -= T - ti++;
    tj = ti + x;
  } else {
    ti = blockIdx.x / T;
    tj = blockIdx.x % T;
  }
  const int m0 = ti * kTile, j0 = tj * kTile;
  const bool mirror = job.sym && ti != tj;
  const size_t off = (size_t)blockIdx.y * r * r;
  const float* ab = job.a + off;
  const float* bb = job.b + off;
  const int steps = ceil_div(r, kBK);
  auto stage = [&](int s) {
    float* dst = sm + (s & 1) * kStage;
    const int k0 = s * kBK;
    stage_block<kTile, kBK, kLdA>(dst, ab, m0, r, k0, r, vec != 0);
    stage_rows(dst + kA, bb, k0, r, j0, r, vec != 0);
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
    const float* sa = sm + (s & 1) * kStage;
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
    __syncthreads();
  }
  tcore::cp_async_wait<0>();
  float* cb = job.c + off;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int i = m0 + wm + 16 * mt + gq + (q >> 1) * 8;
        const int j = j0 + wn + 8 * nt + 2 * t + (q & 1);
        if (i < r && j < r) {
          const float v = acc[mt][nt][q];
          const float x = job.ns_t ? 0.5f * ((i == j ? 3.f : 0.f) - v) : v;
          cb[(size_t)i * r + j] = x;
          if (mirror) cb[(size_t)j * r + i] = x;
        }
      }
}

// S = sym(B) and B^T, elementwise; grid (kEwBlocks, batch)
__global__ void __launch_bounds__(kEw)
ns_sym_kernel(const float* __restrict__ pb, float* __restrict__ s,
           float* __restrict__ bt, int r) {
  const size_t rr = (size_t)r * r, off = blockIdx.y * rr;
  for (size_t e = blockIdx.x * (size_t)kEw + threadIdx.x; e < rr;
       e += (size_t)gridDim.x * kEw) {
    const int i = (int)(e / r), j = (int)(e % r);
    const float bij = pb[off + e], bji = pb[off + (size_t)j * r + i];
    s[off + e] = 0.5f * (bij + bji);
    bt[off + e] = bji;
  }
}

// A = I + u^T u,  u^T u = C - B^T S - (B^T S)^T + S S (p1 = B^T S,
// p2 = S S), one warp a row, and the row's sum of |A_ij| (a fixed
// shuffle tree); grid (ceil(r / kRowWarps), batch)
__global__ void __launch_bounds__(32 * kRowWarps)
ns_form_a_kernel(const float* __restrict__ pc, const float* __restrict__ p1,
              const float* __restrict__ p2, float* __restrict__ a,
              float* __restrict__ rowsum, int r) {
  const int lane = threadIdx.x & 31;
  const int i = blockIdx.x * kRowWarps + (threadIdx.x >> 5);
  if (i >= r) return;   // whole warps leave: no shuffle below misses a lane
  const size_t off = blockIdx.y * (size_t)r * r;
  float acc = 0.f;
  for (int j = lane; j < r; j += 32) {
    const size_t e = off + (size_t)i * r + j;
    const float x = (i == j ? 1.f : 0.f) +
                    (((pc[e] - p1[e]) - p1[off + (size_t)j * r + i]) + p2[e]);
    a[e] = x;
    acc += fabsf(x);
  }
  for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
  if (lane == 0) rowsum[(size_t)blockIdx.y * r + i] = acc;
}

// c = max_i rowsum_i + 1e-6 (each block over the node's r row sums),
// Y_0 = A / c in place, Z_0 = I; block 0 keeps c; grid (kEwBlocks, batch)
__global__ void __launch_bounds__(kEw)
ns_scale_kernel(float* __restrict__ y, float* __restrict__ z,
             const float* __restrict__ rowsum, float* __restrict__ cbuf,
             int r) {
  __shared__ float c_sh;
  const int b = blockIdx.y;
  if (threadIdx.x < 32) {
    float m = 0.f;
    for (int i = threadIdx.x; i < r; i += 32)
      m = fmaxf(m, rowsum[(size_t)b * r + i]);
    for (int o = 16; o > 0; o >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    if (threadIdx.x == 0) c_sh = m + 1e-6f;
  }
  __syncthreads();
  const float c = c_sh;
  if (blockIdx.x == 0 && threadIdx.x == 0) cbuf[b] = c;
  const size_t rr = (size_t)r * r, off = b * rr;
  for (size_t e = blockIdx.x * (size_t)kEw + threadIdx.x; e < rr;
       e += (size_t)gridDim.x * kEw) {
    y[off + e] = y[off + e] / c;
    z[off + e] = e / r == e % r ? 1.f : 0.f;
  }
}

// M2 = inv = Z / sqrt(c) (z and m2 may be one buffer), W = I - S;
// grid (kEwBlocks, batch)
__global__ void __launch_bounds__(kEw)
ns_finish_kernel(const float* z, const float* __restrict__ s,
              const float* __restrict__ cbuf, float* m2,
              float* __restrict__ w, int r) {
  const float rs = 1.f / sqrtf(cbuf[blockIdx.y]);
  const size_t rr = (size_t)r * r, off = blockIdx.y * rr;
  for (size_t e = blockIdx.x * (size_t)kEw + threadIdx.x; e < rr;
       e += (size_t)gridDim.x * kEw) {
    m2[off + e] = z[off + e] * rs;
    w[off + e] = (e / r == e % r ? 1.f : 0.f) - s[off + e];
  }
}

inline bool aligned(std::initializer_list<const void*> ptrs) {
  for (const void* p : ptrs)
    if (!tall::aligned16(p)) return false;
  return true;
}

// Bytes of shared memory an ns_mm_kernel block asks: two stages of an A
// and a B tile.
constexpr int kMmBytes = 2 *
                          (tall::kTile * tall::kLdA + tall::kBK * tall::kLd) *
                          (int)sizeof(float);
static_assert(kMmBytes <= 48 * 1024,
              "ns_mm_kernel: static shared-memory limit");

// One ns_mm_kernel launch of one or two products.
inline int mm(Mm a, Mm b, int jobs, int batch, int r, cudaStream_t st) {
  using namespace tall;
  const int vec = r % 4 == 0 && aligned({a.a, a.b, a.c}) &&
                  (jobs < 2 || aligned({b.a, b.b, b.c}));
  const int T = ceil_div(r, kTile);
  const bool all_sym = a.sym && (jobs < 2 || b.sym);
  const int tiles = all_sym ? T * (T + 1) / 2 : T * T;
  ns_mm_kernel<<<dim3((unsigned)tiles, (unsigned)batch, (unsigned)jobs),
                 kThreads, kMmBytes, st>>>(MmPair{{a, b}}, r, vec);
  return (int)cudaGetLastError();
}

// Floats of scratch: four (batch, r, r) matrices, the row sums, c.
inline size_t workspace(int batch, int r) {
  return 4 * (size_t)batch * r * r + (size_t)batch * r + batch;
}

int finalize(const float* pb, const float* pc, float* m1, float* m2,
             float* ws, int batch, int r, int ns_iters, cudaStream_t st) {
  const size_t mat = (size_t)batch * r * r;
  float* s = ws;                 // S, kept to the end
  float* w1 = ws + mat;          // B^T, then A, then Y (or Y_new)
  float* w2 = ws + 2 * mat;      // B^T S, then Z (or Z_new)
  float* w3 = ws + 3 * mat;      // S S, then T, then I - S
  float* rowsum = ws + 4 * mat;
  float* cbuf = rowsum + (size_t)batch * r;
  const dim3 ew(kEwBlocks, batch);
  int err;
  ns_sym_kernel<<<ew, kEw, 0, st>>>(pb, s, w1, r);
  if ((err = (int)cudaGetLastError())) return err;
  if ((err = mm({w1, s, w2, 0, 0}, {s, s, w3, 0, 1}, 2, batch, r, st)))
    return err;
  ns_form_a_kernel<<<dim3((r + kRowWarps - 1) / kRowWarps, batch),
                  32 * kRowWarps, 0, st>>>(pc, w2, w3, w1, rowsum, r);
  if ((err = (int)cudaGetLastError())) return err;
  ns_scale_kernel<<<ew, kEw, 0, st>>>(w1, w2, rowsum, cbuf, r);
  if ((err = (int)cudaGetLastError())) return err;
  float *y = w1, *z = w2, *yn = m1, *zn = m2;
  for (int it = 0; it < ns_iters; ++it) {
    if ((err = mm({z, y, w3, 1, 1}, {}, 1, batch, r, st))) return err;
    if ((err = mm({y, w3, yn, 0, 1}, {w3, z, zn, 0, 1}, 2, batch, r, st)))
      return err;
    float* tmp = y; y = yn; yn = tmp;
    tmp = z; z = zn; zn = tmp;
  }
  ns_finish_kernel<<<ew, kEw, 0, st>>>(z, s, cbuf, m2, w3, r);
  if ((err = (int)cudaGetLastError())) return err;
  return mm({w3, m2, m1, 0, 0}, {}, 1, batch, r, st);
}

}  // namespace glob

}  // namespace

// CTAs per node of the (r, r) stage: 1 for r <= 32, else the cluster size
// up to kMaxR; 0 above kMaxR (the global route, no cluster); -1 for r < 1.
// For tests and the smoke run.
REPRO_API int repro_fused_retract_cluster(int r) {
  if (r < 1) return -1;
  if (r > kMaxR) return 0;
  return stage_for(r).cs;
}

// The resources of one kernel of a call on (batch, d, r) operands: 0 the
// Gram (tall.cuh, B and C), 1 the apply, 2 the (r, r) stage up to kMaxR
// (one block a node for r <= kSmallR, else a cluster); above kMaxR the
// stage's kernels over global memory: 3 ns_mm_kernel, 4 ns_sym_kernel,
// 5 ns_form_a_kernel, 6 ns_scale_kernel, 7 ns_finish_kernel.
REPRO_API int repro_fused_retract_resources(int batch, int d, int r,
                                            int kernel,
                                            ReproResources* out) {
  if (r < 1 || d < 1 || batch < 1 || kernel < 0 || kernel > 7 ||
      (kernel == 2 && r > kMaxR) || (kernel > 2 && r <= kMaxR))
    return (int)cudaErrorInvalidValue;
  switch (kernel) {
    case 0:
      return tall::gram_resources<tall::kGramTwo>(batch, d, r, out);
    case 1:
      return tall::apply_resources<tall::kApplyRetract>(out);
    case 2: {
      const Stage s = stage_for(r);
      return repro_resources(s.kernel, s.threads, s.smem, s.cs, out);
    }
    case 3:
      return repro_resources(&glob::ns_mm_kernel, tall::kThreads,
                             glob::kMmBytes, 1, out);
    case 4:
      return repro_resources(&glob::ns_sym_kernel, glob::kEw, 0, 1, out);
    case 5:
      return repro_resources(&glob::ns_form_a_kernel, 32 * glob::kRowWarps,
                             0, 1, out);
    case 6:
      return repro_resources(&glob::ns_scale_kernel, glob::kEw, 0, 1, out);
    default:
      return repro_resources(&glob::ns_finish_kernel, glob::kEw, 0, 1, out);
  }
}

// Floats of scratch ``ws`` a call needs (0 up to kMaxR).
REPRO_API long long repro_fused_retract_workspace(int batch, int r) {
  return r > kMaxR ? (long long)glob::workspace(batch, r) : 0;
}

// x, g, out: (batch, d, r), r >= 1; pb, pc: (batch, r, r), the Grams B and
// C; m1, m2: (batch, r, r); ws: repro_fused_retract_workspace floats (null
// when 0).  Three launches up to kMaxR, 2 ns_iters + 8 above.
REPRO_API int repro_fused_retract(const float* x, const float* g, float* out,
                                  float* pb, float* pc, float* m1, float* m2,
                                  float* ws, int batch, int d, int r,
                                  int ns_iters, void* stream) {
  if (r < 1 || (r > kMaxR && ws == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int err = tall::launch_gram<tall::kGramTwo>(x, g, pb, pc, batch, d, r, st);
  if (err != 0) return err;
  err = r > kMaxR ? glob::finalize(pb, pc, m1, m2, ws, batch, r, ns_iters, st)
                  : launch_finalize(pb, pc, m1, m2, batch, r, ns_iters, st);
  if (err != 0) return err;
  return tall::launch_apply<tall::kApplyRetract>(x, g, m1, m2, out, batch, d,
                                                 r, st);
}
