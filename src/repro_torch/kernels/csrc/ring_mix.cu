// One ring gossip hop on each leaf of a group of node-stacked leaves:
//   out[i] = wc x[i] + ws (x[i-1] + x[i+1]),  neighbours wrapped mod n.
//
// Replaces: src/repro/kernels/ring_mix.py, ring_mix_flat (_mix_kernel), the
// fp32 combine of one hop on flat (rows, 1024) panels.
//
// Bound on the H100: bytes.  4 flops per element against 8 bytes (read x
// once, write out once); the neighbour rows are read again by the blocks of
// the rows beside them, mostly from L2.  At the main step the trees are
// small (2.1 M elements in all, under 5 us of HBM time), so what the card
// sees is the host's launch rate.
//
// Design: the TPU kernel took the two neighbour rows as separate inputs
// (the caller rolled them).  Here the kernel reads them by wrapped row
// index, so no rolled copies are made.  One launch mixes up to kMaxLeaves
// leaves (leaves.cuh): grid.y is the node row, grid.x holds each leaf's
// blocks in turn, and a leaf's blocks stride over its columns with float4
// accesses where its row length and both pointers allow, scalar ones
// elsewhere (f = 3 for y and v).  The combine rounds each operation on its
// own (common.cuh), so the result is bitwise the plain
// wc*x + ws*(roll(x, 1) + roll(x, -1)).
#include "leaves.cuh"

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocksPerLeaf = 1024;

__device__ __forceinline__ float4 combine4(float4 a, float4 l, float4 r,
                                           float wc, float ws) {
  return make_float4(ring_combine(a.x, l.x, r.x, wc, ws),
                     ring_combine(a.y, l.y, r.y, wc, ws),
                     ring_combine(a.z, l.z, r.z, wc, ws),
                     ring_combine(a.w, l.w, r.w, wc, ws));
}

template <typename T>
__device__ __forceinline__ void hop_row(const T* __restrict__ x,
                                        T* __restrict__ out, long long cols,
                                        int n, long long start,
                                        long long stride, float wc,
                                        float ws) {
  const int i = blockIdx.y;
  const int il = i == 0 ? n - 1 : i - 1, ir = i == n - 1 ? 0 : i + 1;
  const T* xs = x + (size_t)i * cols;
  const T* xl = x + (size_t)il * cols;
  const T* xr = x + (size_t)ir * cols;
  T* o = out + (size_t)i * cols;
  for (long long c = start; c < cols; c += stride) {
    if constexpr (sizeof(T) == sizeof(float4))
      o[c] = combine4(xs[c], xl[c], xr[c], wc, ws);
    else
      o[c] = ring_combine(xs[c], xl[c], xr[c], wc, ws);
  }
}

__global__ void __launch_bounds__(kThreads)
    ring_mix_group_kernel(const __grid_constant__ LeafGroup g, int n,
                          float wc, float ws) {
  const Leaf& l = g.leaf[leaf_of(g, blockIdx.x)];
  const long long start =
      (blockIdx.x - l.first) * (long long)kThreads + threadIdx.x;
  const long long stride = l.blocks * kThreads;
  if (l.vec)
    hop_row(reinterpret_cast<const float4*>(l.x),
            reinterpret_cast<float4*>(l.out), l.f / 4, n, start, stride, wc,
            ws);
  else
    hop_row(l.x, l.out, l.f, n, start, stride, wc, ws);
}

}  // namespace

// xs, outs, fs: count (1 <= count <= kMaxLeaves) leaves, leaf j (n, fs[j])
// contiguous fp32 at xs[j] and outs[j]; n <= 65535.  One launch.
REPRO_API int repro_ring_mix(const float* const* xs, float* const* outs,
                             const long long* fs, int count, int n, float wc,
                             float ws, void* stream) {
  LeafGroup g;
  const long long total =
      fill_group(g, xs, outs, fs, count, [](Leaf& l) {
        l.vec = l.f % 4 == 0 && reinterpret_cast<uintptr_t>(l.x) % 16 == 0 &&
                reinterpret_cast<uintptr_t>(l.out) % 16 == 0;
        const long long cols = l.vec ? l.f / 4 : l.f;
        const long long b = (cols + kThreads - 1) / kThreads;
        return b < 1 ? 1LL : (b > kMaxBlocksPerLeaf ? kMaxBlocksPerLeaf : b);
      });
  if (total < 0 || n < 1) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)total, (unsigned)n);
  ring_mix_group_kernel<<<grid, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(g, n, wc, ws);
  REPRO_LAUNCH_CHECK();
  return 0;
}

// The resources of the kernel at its one launch configuration.
REPRO_API int repro_ring_mix_resources(ReproResources* out) {
  return repro_resources(&ring_mix_group_kernel, kThreads, 0, 1, out);
}
