// k int8-compressed ring gossip hops in one launch on each leaf of a group
// of node-stacked leaves.  Hop 0 decodes the wire payload (q int8, one fp32
// scale per node row) and combines; every later hop first requantizes each
// row deterministically,
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
// ridge.  At the main path's sizes a hop is a chain of dependent steps
// ending in a reduction over every column, so latency, not the bound, sets
// the time: what counts is the number of barriers and round trips a hop.
//
// Design: every hop after the first needs each row's max-abs over all F
// columns of its leaf before any element of that row can be requantized,
// and blocks on the card run in no order, so the TPU kernel's sequential
// grid cannot be carried over.  Each thread owns fixed columns of ALL n rows
// of one leaf for every hop, so the fp32 state it reads at a hop is the
// state it wrote at the hop before: the state needs no barrier, only the
// row maxima do.  Up to kMaxLeaves leaves (the x, u or y tree of a step)
// share one launch and one barrier a hop: block b belongs to one leaf
// (leaves.cuh's leaf_of), and each (leaf, row) keeps its own maximum, so
// every leaf's result is bitwise what a launch of its own gives.  Row
// maxima: the block's maximum of each row, then
//   * one block in the launch (y alone: 3 columns, one warp): the block's
//     maxima are the rows' maxima; the hop ends in __syncthreads, no grid
//     barrier;
//   * more blocks: one atomicMax per (block, row) on the float bits (|z| >=
//     0, so the bits order as unsigned integers; max is exact and
//     order-free) and one cooperative grid barrier.  Three (count, n)
//     maxima slots rotate: hop h writes slot h % 3, the next hop reads it,
//     and block 0 clears slot (h + 1) % 3 (last read before the barrier of
//     hop h - 1, written first after the barrier of hop h).
// Two routes for the state, chosen by the wrapper:
//   * on chip (quant_hops_reg_kernel<N, T>, n <= kMaxRegRows): while one
//     column per thread fits the resident grid, each thread keeps its
//     column's N values in registers for every hop, with the rows unrolled
//     at compile time (N independent requantize-and-combine chains a hop);
//     q is read once and out written once.  Blocks of 512 threads, so the
//     main path's x tree (51592 columns) is 103 blocks and its hop barrier
//     has half as many blocks to gather as at 256; the block's row maxima
//     are one redux.sync per row and warp, then one across the warps.
//   * in global memory (quant_hops_kernel, larger payloads or rings): the
//     blocks of each leaf stride over its columns, and the state goes
//     through two global (n, F) buffers a leaf, ping-pong, one of them the
//     output.  A thread decodes its column of all n rows into shared memory
//     first (n independent loads in flight), then walks the rows.
// The requantization is exact: the quotient z / scale comes from z times
// the reciprocal where that provably rounds to the same integer, and from
// an IEEE division (__fdiv_rn) where it might not (rint_quot); rint rounds
// half to even and the clips are fminf/fmaxf.  Every product and sum is
// rounded on its own, so the result is bitwise the plain version: the JAX
// package's halo-panel oracle on the wrapped panel, and k hops of
// quantize_det + quant_mix.
#include <cooperative_groups.h>

#include "leaves.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;       // the global route's block width
constexpr int kWarps = kThreads / 32;
constexpr int kRegThreads = 512;    // multi_hop_mix.py's QUANT_BLOCK
constexpr int kTinyThreads = 32;    // one block for one leaf of <= 32 columns
constexpr int kMaxRegRows = 32;     // multi_hop_mix.py's MAX_REG_ROWS

struct QLeaf {
  const int8_t* q;    // (n, f) contiguous payload
  const float* s;     // (n,) scales
  float* out;         // (n, f) contiguous
  float* scratch;     // (n, f), the global route's second state buffer
  long long f;        // columns of the leaf
  long long first;    // the leaf's first block in grid.x
  long long blocks;   // its blocks
};

struct QGroup {
  QLeaf leaf[kMaxLeaves];
  int count;
};

__device__ __forceinline__ float row_scale(unsigned int amax_bits) {
  return fmaxf(__fdiv_rn(__uint_as_float(amax_bits), 127.0f), 1e-12f);
}

// 1 / scale on the special-function unit (at most 1 ulp off; scale >=
// 1e-12 is normal, so flushing denormals changes nothing)
__device__ __forceinline__ float rcp_approx(float x) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// rint(z / scale), the IEEE quotient rounded half to even, from the product
// y = z * rcp (rcp = rcp_approx(scale)).  Here |z / scale| <= 127 (scale is
// the row's max |z| / 127, or the 1e-12 floor above it), so y is within
// 127 (2^-23 + 2^-24) = 2.3e-5 of z / scale and the IEEE quotient within
// 7.6e-6 more: rint(y) is the quotient's rint unless y lies within 1e-4 of
// a half-integer (|y - rint(y)| is exact), which `near` reports; the caller
// then divides.  An IEEE division is a multi-instruction sequence with a
// branch to a slow path, so the rows' divisions would run one after the
// other; the product keeps them independent.
__device__ __forceinline__ float rint_quot(float z, float rcp, bool& near) {
  const float y = __fmul_rn(z, rcp);
  const float k = rintf(y);
  near = fabsf(0.5f - fabsf(y - k)) < 1e-4f;
  return k;
}

__device__ __forceinline__ float clip127(float k) {
  return fminf(fmaxf(k, -127.0f), 127.0f);
}

// clip(rint(z / scale), +-127), the requantization of quantize_det
__device__ __forceinline__ float requant(float z, float scale, float rcp) {
  bool near;
  const float k = rint_quot(z, rcp, near);
  return clip127(near ? rintf(__fdiv_rn(z, scale)) : k);
}

__device__ __forceinline__ float warp_max(float m) {
  for (int o = 16; o > 0; o >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  return m;
}

// The end of hop h for a block of leaf j, from bm[i], the block's maximum
// |z| of row i (float bits; the caller synchronized after writing it):
// the next hop's row scales in sc and their reciprocals in rc.  One block
// in the grid: directly.  More: atomicMax into slot h % 3, block 0 clears
// slot (h + 1) % 3, the grid barrier, then the slot's values.  Ends with
// the block synchronized.
__device__ __forceinline__ void next_scales(const unsigned int* bm, float* sc,
                                            float* rc, unsigned int* amax,
                                            int count, int j, int n, int h) {
  const int t = threadIdx.x;
  if (gridDim.x == 1) {
    for (int i = t; i < n; i += blockDim.x) {
      sc[i] = row_scale(bm[i]);
      rc[i] = rcp_approx(sc[i]);
    }
  } else {
    unsigned int* slot = amax + (size_t)(h % 3) * count * n + (size_t)j * n;
    for (int i = t; i < n; i += blockDim.x) atomicMax(slot + i, bm[i]);
    if (blockIdx.x == 0) {
      unsigned int* next = amax + (size_t)((h + 1) % 3) * count * n;
      for (int k = t; k < count * n; k += blockDim.x) next[k] = 0u;
    }
    cg::this_grid().sync();
    for (int i = t; i < n; i += blockDim.x) {
      sc[i] = row_scale(slot[i]);
      rc[i] = rcp_approx(sc[i]);
    }
  }
  __syncthreads();
}

// On chip: one column (c < f) of all N rows of one leaf per thread, in
// registers for every hop.  Threads past the leaf's columns carry zeros
// and take part in the barriers.  Row maxima: one redux.sync a row and
// warp (|z| bits as unsigned), then one a row across the warps' results.
template <int N, int T>
__global__ void __launch_bounds__(T)
    quant_hops_reg_kernel(const __grid_constant__ QGroup g,
                          unsigned int* amax, int hops, float wc, float ws) {
  constexpr int W = T / 32;
  __shared__ float sc[N], rc[N];
  __shared__ unsigned int red[W][N];
  __shared__ unsigned int bm[N];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int j = leaf_of(g, blockIdx.x);
  const QLeaf& l = g.leaf[j];
  const long long f = l.f;
  const long long c = (blockIdx.x - l.first) * (long long)T + t;
  const bool live = c < f;
  for (int i = t; i < N; i += T) sc[i] = l.s[i];
  __syncthreads();
  float z[N], dq[N];
#pragma unroll
  for (int i = 0; i < N; ++i)
    dq[i] = live ? __fmul_rn((float)l.q[i * f + c], sc[i]) : 0.0f;
  for (int h = 0;; ++h) {
    if (h > 0) {
      // every row's quotient from its product first, then the IEEE
      // division for the rare rows near a half-integer
      unsigned int near_rows = 0u;
#pragma unroll
      for (int i = 0; i < N; ++i) {
        bool near;
        dq[i] = rint_quot(z[i], rc[i], near);
        near_rows |= (unsigned int)near << i;
      }
      if (near_rows) {
#pragma unroll
        for (int i = 0; i < N; ++i)
          if ((near_rows >> i) & 1u) dq[i] = rintf(__fdiv_rn(z[i], sc[i]));
      }
#pragma unroll
      for (int i = 0; i < N; ++i) dq[i] = __fmul_rn(clip127(dq[i]), sc[i]);
    }
#pragma unroll
    for (int i = 0; i < N; ++i)
      z[i] = ring_combine(dq[i], dq[i == 0 ? N - 1 : i - 1],
                          dq[i == N - 1 ? 0 : i + 1], wc, ws);
    if (h == hops - 1) break;
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const unsigned int m =
          __reduce_max_sync(0xffffffffu, __float_as_uint(fabsf(z[i])));
      if (lane == 0) red[warp][i] = m;
    }
    __syncthreads();
    if constexpr (W > 1) {
      for (int i = warp; i < N; i += W) {
        const unsigned int m =
            __reduce_max_sync(0xffffffffu, lane < W ? red[lane][i] : 0u);
        if (lane == 0) bm[i] = m;
      }
      __syncthreads();
      next_scales(bm, sc, rc, amax, g.count, j, N, h);
    } else {
      next_scales(red[0], sc, rc, amax, g.count, j, N, h);
    }
  }
  if (live) {
#pragma unroll
    for (int i = 0; i < N; ++i) l.out[i * f + c] = z[i];
  }
}

// In global memory.  Shared memory: sc[n] and rc[n] (the row scales of this
// hop's input and their reciprocals), bm[n] (the block's row maxima), then
// two (n, kThreads) tiles: dq (the decoded values of the thread's column)
// and mx (the thread's running |z| maximum of each row).
__global__ void __launch_bounds__(kThreads)
    quant_hops_kernel(const __grid_constant__ QGroup g, unsigned int* amax,
                      int n, int hops, float wc, float ws) {
  extern __shared__ float smem[];
  float* sc = smem;
  float* rc = smem + n;
  unsigned int* bm = reinterpret_cast<unsigned int*>(smem + 2 * n);
  float* dq = smem + 3 * n;
  float* mx = dq + (size_t)n * kThreads;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int j = leaf_of(g, blockIdx.x);
  const QLeaf& l = g.leaf[j];
  const long long f = l.f;
  const long long stride = l.blocks * kThreads;
  for (int i = t; i < n; i += kThreads) sc[i] = l.s[i];

  for (int h = 0; h < hops; ++h) {
    // the last hop writes the output; hops alternate between the buffers
    float* dst = ((hops - 1 - h) & 1) ? l.scratch : l.out;
    const float* src = ((hops - h) & 1) ? l.scratch : l.out;
    for (int i = 0; i < n; ++i) mx[i * kThreads + t] = 0.0f;
    __syncthreads();

    // each thread touches only its own column of dq and mx: no barrier
    for (long long c = (blockIdx.x - l.first) * kThreads + t; c < f;
         c += stride) {
#pragma unroll 4
      for (int i = 0; i < n; ++i) {
        const size_t at = (size_t)i * f + c;
        const float v =
            h == 0 ? (float)l.q[at] : requant(src[at], sc[i], rc[i]);
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
    if (h == hops - 1) break;
    __syncthreads();
    // row maxima of the block: warp w reduces rows w, w + kWarps, ...
    for (int i = warp; i < n; i += kWarps) {
      float m = 0.0f;
      for (int k = lane; k < kThreads; k += 32) m = fmaxf(m, mx[i * kThreads + k]);
      m = warp_max(m);
      if (lane == 0) bm[i] = __float_as_uint(m);
    }
    __syncthreads();
    next_scales(bm, sc, rc, amax, g.count, j, n, h);
  }
}

// quant_hops_reg_kernel<n, T> (N runs from 1 to kMaxRegRows), or nullptr.
template <int N>
const void* reg_kernel(int n, bool tiny) {
  if constexpr (N > kMaxRegRows) {
    return nullptr;
  } else {
    if (n != N) return reg_kernel<N + 1>(n, tiny);
    return tiny ? reinterpret_cast<const void*>(
                      &quant_hops_reg_kernel<N, kTinyThreads>)
                : reinterpret_cast<const void*>(
                      &quant_hops_reg_kernel<N, kRegThreads>);
  }
}

long long global_smem(int n) {
  return (long long)n * (3 + 2 * kThreads) * (long long)sizeof(float);
}

cudaError_t resident_blocks(const void* fn, int threads, size_t smem,
                            long long* out) {
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    device)) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, fn, threads, smem)) != cudaSuccess)
    return err;
  *out = (long long)per_sm * sms;
  return cudaSuccess;
}

}  // namespace

// Bytes of dynamic shared memory the global route needs for n rows.
REPRO_API long long repro_multi_hop_mix_quant_smem(int n) {
  return global_smem(n);
}

// Blocks of kRegThreads of the on-chip route of an n-node ring that the
// card holds at once (0 for n > kMaxRegRows): a launch of up to that many
// blocks keeps its state in registers.
REPRO_API long long repro_multi_hop_mix_quant_capacity(int n) {
  const void* fn = reg_kernel<1>(n, false);
  long long blocks = 0;
  if (fn == nullptr ||
      resident_blocks(fn, kRegThreads, 0, &blocks) != cudaSuccess)
    return 0;
  return blocks;
}

// qs, ss, outs, scratch, fs: count (1 <= count <= kMaxLeaves) leaves, leaf j
// an int8 (n, fs[j]) payload at qs[j] with (n,) fp32 scales at ss[j], its
// fp32 (n, fs[j]) output at outs[j]; scratch[j], an (n, fs[j]) fp32 buffer,
// is read only on the global route with hops > 1.  amax: 3 count n uint32
// of scratch.  onchip: 1 for the register route (n <= kMaxRegRows, and
// one block per kRegThreads columns of each leaf within
// repro_multi_hop_mix_quant_capacity(n) blocks; one leaf of at most 32
// columns takes a single warp), 0 for the global route.  One launch,
// cooperative when it has more than one block; a launch the card refuses
// returns its error.
REPRO_API int repro_multi_hop_mix_quant(const int8_t* const* qs,
                                        const float* const* ss,
                                        float* const* outs,
                                        float* const* scratch,
                                        const long long* fs, int count,
                                        unsigned int* amax, int n, int hops,
                                        float wc, float ws, int onchip,
                                        void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (count < 1 || count > kMaxLeaves || n < 1 || hops < 1)
    return (int)cudaErrorInvalidValue;
  const bool tiny = onchip && count == 1 && fs[0] <= kTinyThreads;
  const int threads = !onchip ? kThreads : tiny ? kTinyThreads : kRegThreads;
  const void* fn = onchip ? reg_kernel<1>(n, tiny)
                          : reinterpret_cast<const void*>(&quant_hops_kernel);
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  size_t smem = 0;
  cudaError_t err;
  long long cap = 0, want = 0, total = 0, f_all = 0;
  for (int k = 0; k < count; ++k) {
    want += (fs[k] + threads - 1) / threads;
    f_all += fs[k];
  }
  if (!onchip) {
    smem = (size_t)global_smem(n);
    err = cudaFuncSetAttribute(quant_hops_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    if ((err = resident_blocks(fn, threads, smem, &cap)) != cudaSuccess)
      return (int)err;
    if (cap < 2 * kMaxLeaves) return (int)cudaErrorCooperativeLaunchTooLarge;
  }
  QGroup g = {};
  g.count = count;
  for (int k = 0; k < count; ++k) {
    QLeaf& l = g.leaf[k];
    l.q = qs[k];
    l.s = ss[k];
    l.out = outs[k];
    l.scratch = scratch ? scratch[k] : nullptr;
    l.f = fs[k];
    l.first = total;
    l.blocks = (fs[k] + threads - 1) / threads;
    if (!onchip && want > cap) {
      // a share of the resident grid by columns, at least one block
      const long long share = (cap - count) * fs[k] / f_all;
      l.blocks = share < 1 ? 1 : share < l.blocks ? share : l.blocks;
    }
    if (!onchip && hops > 1 && l.scratch == nullptr)
      return (int)cudaErrorInvalidValue;
    total += l.blocks;
  }
  const int slots = 3 * count * n;
  if (total > 1 &&
      (err = cudaMemsetAsync(amax, 0, slots * sizeof(unsigned int), st)) !=
          cudaSuccess)
    return (int)err;
  void* args_reg[] = {(void*)&g, (void*)&amax, (void*)&hops, (void*)&wc,
                      (void*)&ws};
  void* args_glob[] = {(void*)&g,    (void*)&amax, (void*)&n,
                       (void*)&hops, (void*)&wc,   (void*)&ws};
  void** args = onchip ? args_reg : args_glob;
  if (total > 1)
    err = cudaLaunchCooperativeKernel(fn, dim3((unsigned)total),
                                      dim3(threads), args, smem, st);
  else
    err = cudaLaunchKernel(fn, dim3(1), dim3(threads), args, smem, st);
  if (err != cudaSuccess) return (int)err;
  REPRO_LAUNCH_CHECK();
  return 0;
}
