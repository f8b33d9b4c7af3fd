// k ring gossip hops in one launch on a node-stacked leaf:  out = W^k x for
// the ring  W x[i] = wc x[i] + ws (x[i-1] + x[i+1]),  neighbours mod n.
//
// Replaces: src/repro/kernels/multi_hop_mix.py, multi_hop_mix_flat
// (_mhm_kernel), the fp32 megakernel that runs every hop of a halo panel
// (halo + b + halo, F) as a shrinking pyramid in VMEM.
//
// Bound on the H100: operations for large k, bytes for small k.  Reading x
// once and writing out once is 8 bytes per element; the hops are 4 flops
// per element each, so at the Theorem-1 k = 67 of the 20-node ring it is
// 268 flops per 8 bytes, 33 flops per byte, above the card's fp32 ridge of
// 67 TFLOP/s / 3.35 TB/s = 20.  (The combine is 2 multiplies and 2 adds,
// not FMAs, so the reachable rate is half the table's 67 TFLOP/s.)
//
// Design: the TPU kernel needed a halo panel because each device held only
// b rows of the ring.  On one card every row is local, so a block holds a
// column tile of ALL n ring rows in shared memory and runs the k hops there
// with wrapped neighbours: the same values #4 computes on the wrapped panel
// whose row j is x[(j - k) mod n], without the 2k halo rows, and for any
// k (k > n included).  Each thread owns one column, so the hops need no
// barrier: the thread walks the rows keeping the old value of the row above
// in a register and the old row 0 for the wrap, and updates in place.  One
// read of x and one write of out in all.  The combine rounds every
// operation on its own (common.cuh), so the result is bitwise k repeated
// ring_mix hops.
#include "common.cuh"

namespace {

__global__ void ring_hops_kernel(const float* __restrict__ x,
                                 float* __restrict__ out, int n, long long f,
                                 int hops, float wc, float ws) {
  extern __shared__ float z[];   // (n, blockDim.x): row i, thread's column
  const int t = threadIdx.x, w = blockDim.x;
  const long long c = blockIdx.x * (long long)w + t;
  const bool live = c < f;
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

}  // namespace

// x, out: (n, f) contiguous fp32; threads: block width (a multiple of 32)
// with n * threads * 4 bytes of shared memory (the wrapper picks it).
REPRO_API int repro_multi_hop_mix(const float* x, float* out, int n,
                                  long long f, int hops, float wc, float ws,
                                  int threads, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = (size_t)n * threads * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      ring_hops_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (f + threads - 1) / threads;
  ring_hops_kernel<<<(unsigned)blocks, threads, smem, st>>>(x, out, n, f,
                                                             hops, wc, ws);
  REPRO_LAUNCH_CHECK();
  return 0;
}
