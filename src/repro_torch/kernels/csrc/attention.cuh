// The online-softmax tile step shared by flash_attention.cu and
// paged_decode.cu (sm_90a, fp32 on CUDA cores).
//
// One block owns R query rows (the rows of a query tile, or the G query
// heads of one kv head in a decode slot) and walks the keys in tiles of BK
// rows staged in shared memory.  The running max m, the running sum l and
// the accumulator acc (R x hdv) stay in shared memory across the tiles: on
// the TPU the sequential grid carried them in VMEM scratch from one grid
// step to the next; on the card blocks run in no order, so the key loop
// runs inside the block.
//
// The arithmetic is the Pallas kernels': q is scaled before the product,
// scores and the softmax are fp32, a masked probability is set to 0
// explicitly (never left to exp underflow), and the output is
// acc / max(l, 1e-30).  A row with no usable key therefore writes exact
// zeros, and a key tile with no usable key changes no bit of (m, l, acc):
// the kernels may skip such tiles.
#pragma once

#include <cuda_bf16.h>

#include "common.cuh"

namespace attn {

constexpr float kNegInf = -1e30f;
constexpr int kMaxHeadDim = 256;
constexpr size_t kMaxSmem = 232448;  // bytes of shared memory a block may use

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// The mask of the Pallas kernels (flash_attention.py:50-56): an empty
// cache row (kp < 0) is never usable; causal keeps kp <= qp; a window
// keeps qp - kp < window (window <= 0: none).
__device__ __forceinline__ bool usable(int qp, int kp, bool causal,
                                       int window) {
  return kp >= 0 && (!causal || kp <= qp) && (window <= 0 || qp - kp < window);
}

// Shared-memory layout of one block.  Rows of q and k are padded to hd + 1
// floats and rows of s to BK + 1, so that threads reading one column of
// consecutive rows hit distinct banks.
struct Tiles {
  long long* row;  // BK: source row of each key (-1: none), see stage_rows
  float* q;     // R x (hd + 1), scaled
  float* k;     // BK x (hd + 1)
  float* v;     // BK x hdv
  float* s;     // R x (BK + 1): scores, then probabilities
  float* acc;   // R x hdv
  float* m;     // R
  float* l;     // R
  float* corr;  // R
  int* qp;      // R query positions
  int* kp;      // BK key positions (-1: no key)
};

inline size_t smem_bytes(int R, int BK, int hd, int hdv) {
  const size_t floats = (size_t)R * (hd + 1) + (size_t)BK * (hd + 1) +
                        (size_t)BK * hdv + (size_t)R * (BK + 1) +
                        (size_t)R * hdv + 3 * (size_t)R;
  return (size_t)BK * sizeof(long long) + floats * sizeof(float) +
         (size_t)(R + BK) * sizeof(int);
}

// Key-tile rows BK for R query rows: 64, halved while the block's shared
// memory would exceed the card's limit.  Returns 0 if even 8 do not fit.
inline int key_tile(int R, int hd, int hdv) {
  for (int bk = 64; bk >= 8; bk /= 2)
    if (smem_bytes(R, bk, hd, hdv) <= kMaxSmem) return bk;
  return 0;
}

__device__ inline Tiles carve(float* base, int R, int BK, int hd, int hdv) {
  Tiles t;
  t.row = reinterpret_cast<long long*>(base);
  t.q = reinterpret_cast<float*>(t.row + BK);
  t.k = t.q + (size_t)R * (hd + 1);
  t.v = t.k + (size_t)BK * (hd + 1);
  t.s = t.v + (size_t)BK * hdv;
  t.acc = t.s + (size_t)R * (BK + 1);
  t.m = t.acc + (size_t)R * hdv;
  t.l = t.m + R;
  t.corr = t.l + R;
  t.qp = reinterpret_cast<int*>(t.corr + R);
  t.kp = t.qp + R;
  return t;
}

// m = -1e30, l = 0, acc = 0.  The caller synchronizes afterwards.
__device__ inline void init_state(const Tiles& t, int R, int hdv) {
  for (int i = threadIdx.x; i < R * hdv; i += blockDim.x) t.acc[i] = 0.f;
  for (int r = threadIdx.x; r < R; r += blockDim.x) {
    t.m[r] = kNegInf;
    t.l[r] = 0.f;
  }
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Stages the BK rows of one key tile, row c from src + row[c] * width
// (zeros where row[c] < 0), into dst with row stride ld, converted to fp32.
// Every thread starts kUnroll independent loads before it stores any: a
// load-store loop would wait out one memory latency per element.
constexpr int kUnroll = 8;

template <typename T>
__device__ inline void stage_rows(float* dst, int ld,
                                  const T* __restrict__ src,
                                  const long long* row, int BK, int width) {
  const int n = BK * width;
  for (int base = threadIdx.x; base < n; base += blockDim.x * kUnroll) {
    float x[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = base + u * blockDim.x;
      const int c = i / width;
      x[u] = i < n && row[c] >= 0
                 ? to_f32(src[row[c] * width + (i - c * width)])
                 : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = base + u * blockDim.x;
      const int c = i / width;
      if (i < n) dst[c * ld + (i - c * width)] = x[u];
    }
  }
}

// dot(a, b) over n floats in shared memory, four partial sums in flight.
__device__ __forceinline__ float dot4(const float* a, const float* b, int n,
                                      int b_stride) {
  float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
  int d = 0;
  for (; d + 4 <= n; d += 4) {
    s0 = fmaf(a[d], b[d * b_stride], s0);
    s1 = fmaf(a[d + 1], b[(d + 1) * b_stride], s1);
    s2 = fmaf(a[d + 2], b[(d + 2) * b_stride], s2);
    s3 = fmaf(a[d + 3], b[(d + 3) * b_stride], s3);
  }
  for (; d < n; ++d) s0 = fmaf(a[d], b[d * b_stride], s0);
  return (s0 + s1) + (s2 + s3);
}

// One key tile: q, qp, k, v and kp are staged; updates (m, l, acc).
// blockDim.x is a multiple of 32.  Ends without a barrier: the caller
// synchronizes before it overwrites k, v or kp.
__device__ inline void attend_tile(const Tiles& t, int R, int BK, int hd,
                                   int hdv, bool causal, int window) {
  const int tid = threadIdx.x, nt = blockDim.x;
  // scores: consecutive threads take consecutive keys of one row
  for (int i = tid; i < R * BK; i += nt) {
    const int r = i / BK, c = i - r * BK;
    const float dot = dot4(t.q + (size_t)r * (hd + 1),
                           t.k + (size_t)c * (hd + 1), hd, 1);
    t.s[r * (BK + 1) + c] =
        usable(t.qp[r], t.kp[c], causal, window) ? dot : kNegInf;
  }
  __syncthreads();
  // online softmax: one warp per row
  const int warp = tid >> 5, lane = tid & 31, nw = nt >> 5;
  for (int r = warp; r < R; r += nw) {
    float* sr = t.s + r * (BK + 1);
    float mx = kNegInf;
    for (int c = lane; c < BK; c += 32) mx = fmaxf(mx, sr[c]);
    mx = warp_max(mx);
    const float m_prev = t.m[r];
    const float m_new = fmaxf(m_prev, mx);
    const int qp = t.qp[r];
    float sum = 0.f;
    for (int c = lane; c < BK; c += 32) {
      const float p =
          usable(qp, t.kp[c], causal, window) ? expf(sr[c] - m_new) : 0.f;
      sr[c] = p;
      sum += p;
    }
    sum = warp_sum(sum);
    if (lane == 0) {
      const float corr = expf(m_prev - m_new);
      t.corr[r] = corr;
      t.l[r] = t.l[r] * corr + sum;
      t.m[r] = m_new;
    }
  }
  __syncthreads();
  // acc = acc * corr + p @ v: consecutive threads take consecutive columns
  for (int i = tid; i < R * hdv; i += nt) {
    const int r = i / hdv, j = i - r * hdv;
    const float a = dot4(t.s + r * (BK + 1), t.v + j, BK, hdv);
    t.acc[i] = t.acc[i] * t.corr[r] + a;
  }
}

// Sets the kernel's dynamic shared-memory limit to the card's maximum once.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, bool* done) {
  if (*done) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kMaxSmem);
  if (err == cudaSuccess) *done = true;
  return err;
}

}  // namespace attn
