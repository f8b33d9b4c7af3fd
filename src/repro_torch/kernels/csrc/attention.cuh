// What flash_attention.cu and paged_decode.cu share (sm_90a): the element
// types, the position mask, warp reductions and 16-byte cp.async staging.
//
// The arithmetic is the Pallas kernels': q is scaled before the product,
// scores and the softmax are fp32, a masked probability is set to 0
// explicitly (never left to exp underflow), and the output is
// acc / max(l, 1e-30).  A row with no usable key therefore writes exact
// zeros, and a key tile with no usable key changes no bit of (m, l, acc):
// the kernels may skip such tiles.
#pragma once

#include <cuda_bf16.h>

#include <initializer_list>

#include "common.cuh"
#include "tensorcore.cuh"

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

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// 16-byte cp.async staging (tensorcore.cuh)
using tcore::cp_async16;
using tcore::cp_async_commit;
using tcore::cp_async_wait;

// True when every pointer is 16-byte aligned: rows may then move with
// cp_async16 (their byte widths are checked by the callers).
inline bool aligned16(std::initializer_list<const void*> ptrs) {
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return false;
  return true;
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
