// Stiefel tangent projection  P_x(g) = g - x sym(x^T g), node-batched, for
// every Stiefel leaf of a tree at once.
//
// Replaces: src/repro/kernels/stiefel_project.py, stiefel_project_2d
// (_gram_kernel + _apply_kernel, two pallas_calls over a sequential d grid).
//
// Bound on the H100: per node it moves 3 d r floats (read x and g, write
// the result) for 4 d r^2 flops, r / 3 flops per byte.  The fp32 ridge of
// the card is 67 TFLOP/s / 3.35 TB/s = 20 flops per byte, so the fair fc1
// leaf (r = 64, 21 flops per byte) sits on the ridge and the head leaf
// (r = 3) is bound by bytes; both together are about 4 us of work, so what
// the card sees at the fair shapes is the host's launches.
//
// Design.  The TPU kernel carried the Gram in VMEM from one sequential grid
// step to the next.  Blocks on the card run in no order, and the first port
// split the Gram over d chunks into global partials, then added them in a
// second kernel and applied in a third: three launches and two scratch
// tensors per leaf.  Here there are two routes, chosen by shape:
//
//   * On chip (d rows of x and g fit the shared memory of a cluster of
//     4 or 8 CTAs; r <= 128): ONE launch for every Stiefel leaf of a tree,
//     one thread block cluster per (leaf, node).  Leaf descriptors travel
//     by value as a kernel parameter (leaves.cuh), and a cluster finds its
//     leaf from the prefix of cluster counts.  CTA `rank` loads its band
//     of rows of x and g into shared memory once, sums its partial x^T g
//     there (fp32 FMA, 4 x 4 outputs a thread; for small r the rows are
//     split across threads and the pieces added in a fixed order); after
//     a cluster barrier each CTA adds a slice of the (r, r) elements over
//     the cluster's partials in rank order (distributed shared memory),
//     symmetrizes, and pushes the result into every CTA's copy of S; after
//     a second barrier each CTA writes g - x S for its own rows from
//     shared memory.  x and g are read from HBM once; no global partial,
//     no scratch tensor, no reduce launch.  The fair fc1 leaf (20, 784, 64)
//     takes clusters of 4 CTAs (196 rows each, 160 KB), the head leaf
//     (20, 64, 3) shares the launch.
//   * Streaming (the rest: (20, 4096, 256), (20, 4096, 99)): the tall
//     products of tall.cuh on the tensor cores as 3xTF32, a Gram launch
//     (the d reduction split over a cluster per (i <= j) tile pair and
//     added through distributed shared memory, S = sym(x^T g) stored with
//     its mirror) and an apply launch (g - x S): two launches and one
//     (batch, r, r) tensor for S.
#include "leaves.cuh"
#include "tall.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kMaxSmem = 232448;  // bytes of shared memory a block may use
constexpr int kMaxOnchipR = 128;
// the smallest cluster the on-chip route takes, 4 or 8 (doubled to 8 while
// the rows do not fit; kernel_variants.py: 8 from the start was slower)
constexpr int kMinCluster = 4;
static_assert(kMinCluster == 4 || kMinCluster == 8, "clusters of 4 or 8");
// floats for per-thread partial Gram tiles when the rows are split across
// threads (at most kThreads tiles of 16)
constexpr int kScratch = 16 * kThreads;

struct ProjLeaf {
  const float* x;   // (batch, d, r) contiguous
  const float* g;
  float* out;
  long long first;  // the leaf's first cluster in grid.x / CS
  int d, r;
  int vec;          // 16-byte loads allowed
};

struct ProjGroup {
  ProjLeaf leaf[kMaxLeaves];
  int count;
};

// Ways the rows of a CTA's band are split across threads for its partial
// Gram: 1 from r4 = 64 up (one 4 x 4 tile a thread or more), more below,
// at most 16 (the pieces are added one after another).
__host__ __device__ inline int row_split(int r4) {
  const int tiles = (r4 / 4) * (r4 / 4);
  const int ks = tiles >= kThreads ? 1 : kThreads / tiles;
  return ks < 16 ? ks : 16;
}

// Shared-memory layout (floats) of one CTA of the on-chip route: its band
// of P rows of x and of g (row stride ld, columns padded with zeros to
// r4 = r rounded up to 4), its partial Gram (r, r), the full S (r4, r4,
// zero padded) and, where the rows are split, the scratch.
struct Layout {
  int P, P4, ld, r4, part, s, scratch, total;
};

__host__ __device__ inline Layout layout(int d, int r, int cs) {
  Layout l;
  l.P = tall::ceil_div(d, cs);
  l.P4 = (l.P + 3) & ~3;
  l.r4 = (r + 3) & ~3;
  l.ld = l.r4 + 4;
  l.part = 2 * l.P4 * l.ld;
  l.s = l.part + ((r * r + 3) & ~3);
  l.scratch = l.s + l.r4 * l.r4;
  l.total = l.scratch + (row_split(l.r4) > 1 ? kScratch : 0);
  return l;
}

// CTAs per node of the on-chip route for a (d, r) leaf, 0 if it streams.
inline int onchip_cluster(int d, int r) {
  if (d < 1 || r < 1 || r > kMaxOnchipR) return 0;
  for (int cs = kMinCluster; cs <= tall::kMaxCluster; cs *= 2)
    if (layout(d, r, cs).total * (int)sizeof(float) <= kMaxSmem) return cs;
  return 0;
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
// component k of v (k a constant after unrolling)
__device__ __forceinline__ float at(const float4& v, int k) {
  return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}

template <int CS>
__global__ void __launch_bounds__(kThreads)
project_cluster_kernel(const __grid_constant__ ProjGroup grp) {
  extern __shared__ __align__(16) float sm[];
  cg::cluster_group cluster = cg::this_cluster();
  constexpr int cs = CS;
  const int rank = (int)cluster.block_rank();
  const long long c = blockIdx.x / cs;
  const ProjLeaf& L = grp.leaf[leaf_of(grp, c)];
  const int d = L.d, r = L.r, tid = threadIdx.x;
  const Layout lay = layout(d, r, cs);
  const int ld = lay.ld, r4 = lay.r4;
  float* xs = sm;
  float* gs = sm + lay.P4 * ld;
  float* part = sm + lay.part;
  float* s = sm + lay.s;
  float* scratch = sm + lay.scratch;
  const int row0 = rank * lay.P;
  const int rows = max(0, min(lay.P, d - row0));
  const size_t base = ((size_t)(c - L.first) * d + row0) * r;

  // 1. the band of rows, zero padded, every copy in flight at once
  // (cp.async); S zeroed meanwhile (the pushes fill r x r)
  const float* xb = L.x + base;
  const float* gb = L.g + base;
  if (L.vec) {
    const int q = ld / 4;
    for (int e = tid; e < lay.P4 * q; e += kThreads) {
      const int p = e / q, j = 4 * (e % q);
      const bool in = p < rows && j < r;
      const size_t at = in ? (size_t)p * r + j : 0;
      tcore::cp_async16(xs + p * ld + j, xb + at, in);
      tcore::cp_async16(gs + p * ld + j, gb + at, in);
    }
  } else {
    for (int e = tid; e < lay.P4 * ld; e += kThreads) {
      const int p = e / ld, j = e % ld;
      const bool in = p < rows && j < r;
      const size_t at = in ? (size_t)p * r + j : 0;
      tcore::cp_async4(xs + e, xb + at, in);
      tcore::cp_async4(gs + e, gb + at, in);
    }
  }
  tcore::cp_async_commit();
  for (int e = tid; e < r4 * r4; e += kThreads) s[e] = 0.f;
  tcore::cp_async_wait<0>();
  __syncthreads();

  // 2. this CTA's partial x^T g, 4 x 4 outputs a thread; below kThreads
  // tiles the rows are split ks ways and the pieces added in order
  const int t4 = r4 / 4, tiles = t4 * t4;
  const int ks = row_split(r4);
  for (int w = tid; w < tiles * ks; w += kThreads) {
    const int tile = w % tiles, k = w / tiles;
    const int i0 = 4 * (tile / t4), j0 = 4 * (tile % t4);
    float acc[4][4] = {};
#pragma unroll 4
    for (int p = k; p < rows; p += ks) {
      const float4 a = ld4(xs + p * ld + i0), v = ld4(gs + p * ld + j0);
#pragma unroll
      for (int qi = 0; qi < 4; ++qi)
#pragma unroll
        for (int qj = 0; qj < 4; ++qj)
          acc[qi][qj] = fmaf(at(a, qi), at(v, qj), acc[qi][qj]);
    }
    if (ks == 1) {
#pragma unroll
      for (int qi = 0; qi < 4; ++qi)
#pragma unroll
        for (int qj = 0; qj < 4; ++qj)
          if (i0 + qi < r && j0 + qj < r)
            part[(i0 + qi) * r + j0 + qj] = acc[qi][qj];
    } else {
#pragma unroll
      for (int qi = 0; qi < 4; ++qi)
#pragma unroll
        for (int qj = 0; qj < 4; ++qj)
          scratch[16 * w + 4 * qi + qj] = acc[qi][qj];
    }
  }
  if (ks > 1) {
    __syncthreads();
    for (int e = tid; e < r * r; e += kThreads) {
      const int i = e / r, j = e % r;
      const int at = 16 * ((i / 4) * t4 + j / 4) + 4 * (i % 4) + j % 4;
      float v = 0.f;
      for (int k = 0; k < ks; ++k) v += scratch[at + 16 * tiles * k];
      part[e] = v;
    }
  }
  cluster.sync();

  // 3. a slice of S over the cluster's partials, in rank order, pushed to
  // every CTA's copy
  const int rr = r * r, per = tall::ceil_div(rr, cs);
  const int e1 = min(rr, (rank + 1) * per);
  for (int e = rank * per + tid; e < e1; e += kThreads) {
    const int i = e / r, j = e % r;
    float pij[CS], pji[CS];  // every peer's pair, loads in flight together
#pragma unroll
    for (int q = 0; q < CS; ++q) {
      const float* pq = cluster.map_shared_rank(part, q);
      pij[q] = pq[i * r + j];
      pji[q] = pq[j * r + i];
    }
    float gij = 0.f, gji = 0.f;
#pragma unroll
    for (int q = 0; q < CS; ++q) {
      gij += pij[q];
      gji += pji[q];
    }
    const float v = 0.5f * (gij + gji);
#pragma unroll
    for (int q = 0; q < CS; ++q) cluster.map_shared_rank(s, q)[i * r4 + j] = v;
  }
  cluster.sync();  // S complete everywhere; no peer reads this CTA after

  // 4. g - x S for the band, 4 x 4 outputs a thread
  float* out = L.out + base;
  for (int w = tid; w < (lay.P4 / 4) * t4; w += kThreads) {
    const int p0 = 4 * (w / t4), j0 = 4 * (w % t4);
    if (p0 >= rows) continue;
    float acc[4][4] = {};
    for (int k = 0; k < r4; k += 4) {
      float4 a[4], v[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        a[q] = ld4(xs + (p0 + q) * ld + k);
        v[q] = ld4(s + (k + q) * r4 + j0);
      }
#pragma unroll
      for (int qi = 0; qi < 4; ++qi)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int qj = 0; qj < 4; ++qj)
            acc[qi][qj] = fmaf(at(a[qi], kk), at(v[kk], qj), acc[qi][qj]);
    }
#pragma unroll
    for (int qi = 0; qi < 4; ++qi)
#pragma unroll
      for (int qj = 0; qj < 4; ++qj) {
        const int p = p0 + qi, j = j0 + qj;
        if (p < rows && j < r)
          out[(size_t)p * r + j] = gs[p * ld + j] - acc[qi][qj];
      }
  }
}

// One launch of the on-chip route with clusters of CS CTAs.
template <int CS>
int launch_cluster(const ProjGroup& grp, long long clusters, int smem,
                   cudaStream_t st) {
  static bool smem_set = false;
  cudaError_t err =
      tall::set_smem(project_cluster_kernel<CS>, kMaxSmem, &smem_set);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(clusters * CS));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CS;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, project_cluster_kernel<CS>, grp);
}

}  // namespace

// CTAs per node of the on-chip route for a (d, r) leaf; 0 when the leaf
// takes the streaming route.  For the wrapper, the tests and the smoke run.
REPRO_API int repro_stiefel_project_cluster(int d, int r) {
  return onchip_cluster(d, r);
}

// The on-chip route for count (1 <= count <= kMaxLeaves) leaves, leaf j
// (batch[j], d[j], r[j]) contiguous fp32 at xs[j], gs[j], outs[j], every
// one with a nonzero repro_stiefel_project_cluster; all of them take the
// largest cluster any of them needs.  One launch.
REPRO_API int repro_stiefel_project_leaves(const float* const* xs,
                                           const float* const* gs,
                                           float* const* outs,
                                           const int* batch, const int* d,
                                           const int* r, int count,
                                           void* stream) {
  if (count < 1 || count > kMaxLeaves) return (int)cudaErrorInvalidValue;
  int cs = 0;
  for (int j = 0; j < count; ++j) {
    const int need = onchip_cluster(d[j], r[j]);
    if (need == 0 || batch[j] < 1) return (int)cudaErrorInvalidValue;
    cs = need > cs ? need : cs;
  }
  ProjGroup grp = {};
  grp.count = count;
  long long clusters = 0;
  int smem = 0;
  for (int j = 0; j < count; ++j) {
    ProjLeaf& l = grp.leaf[j];
    l.x = xs[j];
    l.g = gs[j];
    l.out = outs[j];
    l.d = d[j];
    l.r = r[j];
    l.first = clusters;
    l.vec = r[j] % 4 == 0 && tall::aligned16(xs[j]) && tall::aligned16(gs[j]);
    clusters += batch[j];
    const int bytes = layout(d[j], r[j], cs).total * (int)sizeof(float);
    smem = bytes > smem ? bytes : smem;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return cs == 4 ? launch_cluster<4>(grp, clusters, smem, st)
                 : launch_cluster<8>(grp, clusters, smem, st);
}

// The streaming route for one (batch, d, r) leaf: s (batch, r, r) receives
// sym(x^T g).  Two launches.
REPRO_API int repro_stiefel_project_stream(const float* x, const float* g,
                                           float* out, float* s, int batch,
                                           int d, int r, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int err = tall::launch_gram<tall::kGramSym>(x, g, s, nullptr, batch, d, r,
                                              st);
  if (err != 0) return err;
  return tall::launch_apply<tall::kApplyProject>(x, g, s, nullptr, out, batch,
                                                 d, r, st);
}
