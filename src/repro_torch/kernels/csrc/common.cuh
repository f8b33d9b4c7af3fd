// Shared pieces of the port's CUDA kernels (sm_90a, fp32 on CUDA cores).
//
// Every kernel library exports plain C functions (loaded from Python with
// ctypes). Each returns the value of cudaGetLastError() after its launches,
// so a refused launch (too many threads, too much shared memory) reaches the
// Python wrapper, which raises.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define REPRO_API extern "C" __attribute__((visibility("default")))

REPRO_API const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

#define REPRO_LAUNCH_CHECK()                    \
  do {                                          \
    cudaError_t err_ = cudaGetLastError();      \
    if (err_ != cudaSuccess) return (int)err_;  \
  } while (0)

// The fp32 ring combine  wc*x + ws*(l + r)  with every operation rounded on
// its own (no FMA contraction): bitwise the same expression as the plain
// PyTorch version, which runs each operation as its own kernel.
__device__ __forceinline__ float ring_combine(float x, float l, float r,
                                              float wc, float ws) {
  return __fadd_rn(__fmul_rn(wc, x), __fmul_rn(ws, __fadd_rn(l, r)));
}
