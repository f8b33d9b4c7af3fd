// k ring gossip hops in one launch on each leaf of a group of node-stacked
// leaves:  out = W^k x  for the ring  W x[i] = wc x[i] + ws (x[i-1] +
// x[i+1]),  neighbours mod n.
//
// Replaces: src/repro/kernels/multi_hop_mix.py, multi_hop_mix_flat
// (_mhm_kernel), the fp32 megakernel that runs every hop of a halo panel
// (halo + b + halo, F) as a shrinking pyramid in VMEM.
//
// Bound on the H100: operations for large k, bytes for small k.  Reading x
// once and writing out once is 8 bytes per element; the hops are 4 flops
// per element each, so at the Theorem-1 k = 67 of the 20-node ring it is
// 268 flops per 8 bytes, 33 flops per byte, above the card's fp32 ridge of
// 67 TFLOP/s / 3.35 TB/s = 20.  The combine is 2 multiplies and 2 adds,
// each rounded on its own (no FMA), so the reachable rate is half the
// table's 67 TFLOP/s: at (20, 1M) and k = 67, 5.36 G instructions take at
// least about 0.16 ms.
//
// Design: the TPU kernel needed a halo panel because each device held only
// b rows of the ring.  On one card every row is local, so a thread owns one
// column of ALL n ring rows and runs the k hops on it with wrapped
// neighbours: the same values the JAX kernel computes on the wrapped panel
// whose row j is x[(j - k) mod n], without the 2k halo rows, and for any
// k (k > n included).  One read of x and one write of out in all; no
// barrier.  Two variants, chosen by n only:
//
//   * n <= kMaxRegRows (32): ring_hops_reg_kernel<N>, the column's N values
//     in registers with the row loop unrolled at compile time.  A hop's N
//     combines are independent (N-way ILP), and nothing is read or written
//     between the first load and the last store.  Each combine reads the
//     OLD values of rows i-1, i and i+1, as the in-place walk of the shared
//     memory kernel does; here the hops alternate between two register
//     arrays, so that no value is copied to keep an old one.  64 threads a
//     block: the main step's x tree (51592 columns) makes 808 blocks, about
//     6 for each of the 132 SMs, and the (20, 1M) stress shape fills every
//     SM to its 32 resident blocks.
//   * n > 32: ring_hops_smem_kernel, the column's rows in shared memory
//     (n * width * 4 bytes a block), updated in place: the thread walks the
//     rows keeping the old value of the row above in a register and the
//     old row 0 for the wrap.
//
// Both group up to kMaxLeaves leaves in one launch (leaves.cuh).  The
// combine rounds every operation on its own (common.cuh), so the result is
// bitwise k repeated ring_mix hops.
#include "leaves.cuh"

namespace {

constexpr int kMaxRegRows = 32;   // multi_hop_mix.py's MAX_REG_ROWS

// b = W a on one column of N rows held in registers.
template <int N>
__device__ __forceinline__ void reg_hop(const float (&a)[N], float (&b)[N],
                                        float wc, float ws) {
#pragma unroll
  for (int i = 0; i < N; ++i)
    b[i] = ring_combine(a[i], a[i == 0 ? N - 1 : i - 1],
                        a[i == N - 1 ? 0 : i + 1], wc, ws);
}

template <int N>
__global__ void __launch_bounds__(256)
    ring_hops_reg_kernel(const __grid_constant__ LeafGroup g, int hops,
                         float wc, float ws) {
  const Leaf& l = g.leaf[leaf_of(g, blockIdx.x)];
  const long long f = l.f;
  const long long c = (blockIdx.x - l.first) * (long long)blockDim.x +
                      threadIdx.x;
  if (c >= f) return;
  const float* __restrict__ x = l.x + c;
  float* __restrict__ out = l.out + c;
  float z[N], w[N];
#pragma unroll
  for (int i = 0; i < N; ++i) z[i] = x[i * f];
  int h = 0;
  for (; h + 1 < hops; h += 2) {
    reg_hop<N>(z, w, wc, ws);
    reg_hop<N>(w, z, wc, ws);
  }
  if (h < hops) {
    reg_hop<N>(z, w, wc, ws);
#pragma unroll
    for (int i = 0; i < N; ++i) out[i * f] = w[i];
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) out[i * f] = z[i];
  }
}

__global__ void ring_hops_smem_kernel(const __grid_constant__ LeafGroup g,
                                      int n, int hops, float wc, float ws) {
  extern __shared__ float z[];   // (n, blockDim.x): row i, thread's column
  const Leaf& l = g.leaf[leaf_of(g, blockIdx.x)];
  const long long f = l.f;
  const int t = threadIdx.x, w = blockDim.x;
  const long long c = (blockIdx.x - l.first) * (long long)w + t;
  const bool live = c < f;
  const float* __restrict__ x = l.x;
  float* __restrict__ out = l.out;
  for (int i = 0; i < n; ++i) z[i * w + t] = live ? x[(size_t)i * f + c] : 0.f;
  for (int h = 0; h < hops; ++h) {
    const float first = z[t];
    float prev = z[(n - 1) * w + t];
    for (int i = 0; i < n; ++i) {
      const float cur = z[i * w + t];
      const float next = i == n - 1 ? first : z[(i + 1) * w + t];
      z[i * w + t] = ring_combine(cur, prev, next, wc, ws);
      prev = cur;
    }
  }
  if (live)
    for (int i = 0; i < n; ++i) out[(size_t)i * f + c] = z[i * w + t];
}

// ring_hops_reg_kernel<n> (N runs from 1 to kMaxRegRows), or nullptr.
template <int N>
const void* reg_kernel(int n) {
  if constexpr (N > kMaxRegRows) {
    return nullptr;
  } else {
    return n == N ? reinterpret_cast<const void*>(&ring_hops_reg_kernel<N>)
                  : reg_kernel<N + 1>(n);
  }
}

}  // namespace

// xs, outs, fs: count (1 <= count <= kMaxLeaves) leaves, leaf j (n, fs[j])
// contiguous fp32 at xs[j] and outs[j].  threads: block width, a multiple
// of 32 (the wrapper picks it: 64 on the register path, n <= 32; on the
// shared-memory path the widest of 256, 128, 64, 32 whose n * threads * 4
// bytes fit a block).  One launch.
REPRO_API int repro_multi_hop_mix(const float* const* xs, float* const* outs,
                                  const long long* fs, int count, int n,
                                  int hops, float wc, float ws, int threads,
                                  void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  LeafGroup g;
  const long long total =
      fill_group(g, xs, outs, fs, count, [threads](Leaf& l) {
        return (l.f + threads - 1) / threads;
      });
  if (total < 0 || n < 1 || threads < 32 || threads > 256)
    return (int)cudaErrorInvalidValue;
  if (n <= kMaxRegRows) {
    void* args[] = {&g, &hops, &wc, &ws};
    cudaLaunchKernel(reg_kernel<1>(n), dim3((unsigned)total), dim3(threads),
                     args, 0, st);
  } else {
    const size_t smem = (size_t)n * threads * sizeof(float);
    if (smem > 48 * 1024) {
      cudaError_t err = cudaFuncSetAttribute(
          ring_hops_smem_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          (int)smem);
      if (err != cudaSuccess) return (int)err;
    }
    ring_hops_smem_kernel<<<(unsigned)total, threads, smem, st>>>(
        g, n, hops, wc, ws);
  }
  REPRO_LAUNCH_CHECK();
  return 0;
}

// The register kernel of an n-node ring (n <= kMaxRegRows): its registers
// per thread and how many blocks of `threads` one SM holds at once.
REPRO_API int repro_multi_hop_mix_resources(int n, int threads, int* regs,
                                            int* blocks_per_sm) {
  const void* fn = reg_kernel<1>(n);
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return (int)err;
  *regs = attr.numRegs;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, fn,
                                                            threads, 0);
}
