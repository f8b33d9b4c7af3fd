// k int8-compressed ring gossip hops in one launch on a node-stacked leaf.
// Hop 0 decodes the wire payload (q int8, one fp32 scale per node row) and
// combines; every later hop first requantizes each row deterministically,
//   scale = max(max_c |z[i, c]| / 127, 1e-12),  q = clip(rint(z / scale), ±127),
// then combines the decoded values:
//   z'[i] = wc (q[i] s[i]) + ws ((q[i-1] s[i-1]) + (q[i+1] s[i+1])),  mod n.
//
// Replaces: src/repro/kernels/multi_hop_mix.py, multi_hop_mix_quant_flat
// (_mhmq_kernel), which carried the row maxima in VMEM scratch across a
// sequential revisiting grid of 2 hops - 1 stages over a halo panel.
//
// Bound on the H100: bytes at few hops, operations at many.  Reading q once
// (1 B) and writing out once (4 B) is 5 bytes per element; each hop is about
// 8 operations per element (a division, a rounding, two clips, a product
// and the 4-operation combine), so at 66 hops it is above the card's fp32
// ridge.
//
// Design: every hop after the first needs each row's max-abs over all F
// columns before any element of that row can be requantized, and blocks on
// the card run in no order, so the TPU kernel's sequential grid cannot be
// carried over.  One cooperative launch (all blocks co-resident) runs every
// hop, with one grid-wide barrier per hop:
//   * each thread owns a fixed set of columns (grid stride) for ALL n rows
//     and for every hop, so the fp32 state it reads at a hop is the state it
//     wrote at the hop before: the state needs no barrier, only the row
//     maxima do.  It lives in two global (n, F) buffers, ping-pong, one of
//     them the output (the fc1 leaf's 4 MB stay in the 50 MB L2);
//   * a hop is a chain of dependent steps per thread, so latency, not
//     bandwidth, bounds it at the main path's sizes.  A thread first
//     decodes its column of all n rows into shared memory (n independent
//     loads in flight), then walks the rows combining from there, keeping
//     the running |z| maximum of each row in shared memory too; each state
//     element is read and requantized once per hop;
//   * row maxima: once per hop a warp reduces each row's column maxima
//     (shuffles), then one atomicMax per row and block on the float bits
//     (|z| >= 0, so the bits order as unsigned integers).  Max is exact and
//     order-free, so the result does not depend on the order the blocks run
//     in.  Three (n,) maxima buffers rotate: hop h reads h-1's, writes h's
//     and clears h+1's (read last at hop h-1, written first at hop h+1).
// Shared memory is (2 * 256 + 1) * 4 bytes per ring node, so a ring of up
// to 113 nodes fits one block.
// Division, rint and the clips are IEEE (__fdiv_rn, rintf half to even,
// fminf/fmaxf), and every product and sum is rounded on its own, so the
// result is bitwise the plain version: the JAX package's halo-panel oracle
// on the wrapped panel, and k hops of quantize_det + quant_mix.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float row_scale(unsigned int amax_bits) {
  return fmaxf(__fdiv_rn(__uint_as_float(amax_bits), 127.0f), 1e-12f);
}

__device__ __forceinline__ float requant(float z, float scale) {
  return fminf(fmaxf(rintf(__fdiv_rn(z, scale)), -127.0f), 127.0f);
}

__device__ __forceinline__ float warp_max(float m) {
  for (int o = 16; o > 0; o >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  return m;
}

// Shared memory: sc[n] (the row scales of this hop's input), then two
// (n, kThreads) tiles: dq (the decoded values of the thread's column) and
// mx (the thread's running |z| maximum of each row).
__global__ void __launch_bounds__(kThreads)
    quant_hops_kernel(const int8_t* __restrict__ q, const float* __restrict__ s,
                      float* out, float* scratch, unsigned int* amax, int n,
                      long long f, int hops, float wc, float ws) {
  extern __shared__ float smem[];
  float* sc = smem;
  float* dq = smem + n;
  float* mx = dq + (size_t)n * kThreads;
  cg::grid_group grid = cg::this_grid();
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const long long stride = (long long)gridDim.x * kThreads;

  for (int h = 0; h < hops; ++h) {
    const bool last = h == hops - 1;
    // the last hop writes the output; hops alternate between the buffers
    float* dst = ((hops - 1 - h) & 1) ? scratch : out;
    const float* src = ((hops - h) & 1) ? scratch : out;
    if (h == 0) {
      for (int j = t; j < n; j += kThreads) sc[j] = s[j];
    } else {
      const unsigned int* prev = amax + (size_t)((h - 1) % 3) * n;
      for (int j = t; j < n; j += kThreads) sc[j] = row_scale(prev[j]);
    }
    if (blockIdx.x == 0) {
      unsigned int* next = amax + (size_t)((h + 1) % 3) * n;
      for (int j = t; j < n; j += kThreads) next[j] = 0u;
    }
    for (int i = 0; i < n; ++i) mx[i * kThreads + t] = 0.0f;
    __syncthreads();

    // each thread touches only its own column of dq and mx: no barrier
    for (long long c = (long long)blockIdx.x * kThreads + t; c < f;
         c += stride) {
      // decode the column of every row first: n independent loads in
      // flight instead of one round trip per row
#pragma unroll 4
      for (int i = 0; i < n; ++i) {
        const size_t at = (size_t)i * f + c;
        const float v = h == 0 ? (float)q[at] : requant(src[at], sc[i]);
        dq[i * kThreads + t] = __fmul_rn(v, sc[i]);
      }
      const float first = dq[t];
      float prev = dq[(n - 1) * kThreads + t];
      float cur = first;
      for (int i = 0; i < n; ++i) {
        const float next = i == n - 1 ? first : dq[(i + 1) * kThreads + t];
        const float z = ring_combine(cur, prev, next, wc, ws);
        dst[(size_t)i * f + c] = z;
        mx[i * kThreads + t] = fmaxf(mx[i * kThreads + t], fabsf(z));
        prev = cur;
        cur = next;
      }
    }
    if (last) break;
    __syncthreads();
    // row maxima of the block: warp w reduces rows w, w + kWarps, ...
    unsigned int* rowmax = amax + (size_t)(h % 3) * n;
    for (int i = warp; i < n; i += kWarps) {
      float m = 0.0f;
      for (int j = lane; j < kThreads; j += 32) m = fmaxf(m, mx[i * kThreads + j]);
      m = warp_max(m);
      if (lane == 0) atomicMax(rowmax + i, __float_as_uint(m));
    }
    grid.sync();
  }
}

}  // namespace

// Bytes of dynamic shared memory the kernel needs for n rows.
REPRO_API long long repro_multi_hop_mix_quant_smem(int n) {
  return (long long)n * (1 + 2 * kThreads) * (long long)sizeof(float);
}

// q: (n, f) contiguous int8; s: (n,) fp32 scales; out, scratch: (n, f) fp32
// (scratch unused when hops == 1); amax: 3 n uint32 of scratch; hops >= 1.
// One cooperative launch; a launch the card refuses returns its error.
REPRO_API int repro_multi_hop_mix_quant(const int8_t* q, const float* s,
                                        float* out, float* scratch,
                                        unsigned int* amax, int n, long long f,
                                        int hops, float wc, float ws,
                                        void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = (size_t)repro_multi_hop_mix_quant_smem(n);
  cudaError_t err = cudaFuncSetAttribute(
      quant_hops_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  int device = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    device)) != cudaSuccess)
    return (int)err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, quant_hops_kernel, kThreads, smem)) != cudaSuccess)
    return (int)err;
  if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  long long blocks = (f + kThreads - 1) / kThreads;
  if (blocks > (long long)per_sm * sms) blocks = (long long)per_sm * sms;
  if (blocks < 1) blocks = 1;
  if ((err = cudaMemsetAsync(amax, 0, 3 * (size_t)n * sizeof(unsigned int),
                             st)) != cudaSuccess)
    return (int)err;
  void* args[] = {(void*)&q,  (void*)&s, (void*)&out,  (void*)&scratch,
                  (void*)&amax, (void*)&n, (void*)&f,  (void*)&hops,
                  (void*)&wc, (void*)&ws};
  err = cudaLaunchCooperativeKernel((const void*)quant_hops_kernel,
                                    dim3((unsigned)blocks), dim3(kThreads),
                                    args, smem, st);
  if (err != cudaSuccess) return (int)err;
  REPRO_LAUNCH_CHECK();
  return 0;
}
