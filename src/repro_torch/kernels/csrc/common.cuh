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

// One kernel's resources at one launch configuration, as the card reports
// them: what cudaFuncGetAttributes says of the compiled kernel, the shared
// memory the launch asks, and how many blocks (no cluster) one SM, or
// clusters the whole card, holds at once (the occupancy calculator).  Each
// library's repro_<name>_resources fills one for the launch its entry point
// would make, for the analysis layer's budget pass
// (repro_torch/analysis/kernel_check.py).
struct ReproResources {
  int regs;         // registers a thread
  int local_bytes;  // local memory a thread (register spills, stack)
  int static_smem;  // static shared memory a block, bytes
  int dyn_smem;     // dynamic shared memory the launch asks, bytes
  int threads;      // threads a block
  int cluster;      // blocks a cluster (1: no cluster)
  int resident;     // blocks an SM (cluster 1), or clusters the card
};

// Fills *out for kernel fn launched with `threads` threads, `dyn` bytes of
// dynamic shared memory and clusters of `cluster` blocks.  Raises the
// kernel's dynamic shared-memory limit to `dyn` where it is below (as the
// launch does first), never lowers it.
inline int repro_resources(const void* fn, int threads, size_t dyn,
                           int cluster, ReproResources* out) {
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncGetAttributes(&a, fn);
  if (err != cudaSuccess) return (int)err;
  if ((int)dyn > a.maxDynamicSharedSizeBytes &&
      (err = cudaFuncSetAttribute(fn,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)dyn)) != cudaSuccess)
    return (int)err;
  out->regs = a.numRegs;
  out->local_bytes = (int)a.localSizeBytes;
  out->static_smem = (int)a.sharedSizeBytes;
  out->dyn_smem = (int)dyn;
  out->threads = threads;
  out->cluster = cluster;
  if (cluster <= 1)
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &out->resident, fn, threads, dyn);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)cluster);
  cfg.blockDim = dim3((unsigned)threads);
  cfg.dynamicSmemBytes = dyn;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaOccupancyMaxActiveClusters(&out->resident, fn, &cfg);
}

template <typename Kernel>
inline int repro_resources(Kernel* kernel, int threads, size_t dyn,
                           int cluster, ReproResources* out) {
  return repro_resources(reinterpret_cast<const void*>(kernel), threads, dyn,
                         cluster, out);
}

// The fp32 ring combine  wc*x + ws*(l + r)  with every operation rounded on
// its own (no FMA contraction): bitwise the same expression as the plain
// PyTorch version, which runs each operation as its own kernel.
__device__ __forceinline__ float ring_combine(float x, float l, float r,
                                              float wc, float ws) {
  return __fadd_rn(__fmul_rn(wc, x), __fmul_rn(ws, __fadd_rn(l, r)));
}
