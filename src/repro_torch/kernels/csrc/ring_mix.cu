// One ring gossip hop on a node-stacked leaf:
//   out[i] = wc x[i] + ws (x[i-1] + x[i+1]),  neighbours wrapped mod n.
//
// Replaces: src/repro/kernels/ring_mix.py, ring_mix_flat (_mix_kernel), the
// fp32 combine of one hop on flat (rows, 1024) panels.
//
// Bound on the H100: bytes.  4 flops per element against 8 bytes (read x
// once, write out once); the neighbour rows are read again by the blocks of
// the rows beside them, mostly from L2.
//
// Design: the TPU kernel took the two neighbour rows as separate inputs
// (the caller rolled them).  Here the kernel reads them by wrapped row
// index, so no rolled copies are made.  grid.y is the node row, grid.x
// strides over the row's columns with float4 accesses where the row length
// allows.  The combine rounds each operation on its own (common.cuh), so
// the result is bitwise the plain  wc*x + ws*(roll(x, 1) + roll(x, -1)).
#include "common.cuh"

namespace {

__global__ void ring_mix_kernel(const float* __restrict__ x,
                                float* __restrict__ out, int n, long long f,
                                float wc, float ws) {
  const int i = blockIdx.y;
  const int il = i == 0 ? n - 1 : i - 1, ir = i == n - 1 ? 0 : i + 1;
  const float* xs = x + (size_t)i * f;
  const float* xl = x + (size_t)il * f;
  const float* xr = x + (size_t)ir * f;
  float* o = out + (size_t)i * f;
  for (long long c = blockIdx.x * (long long)blockDim.x + threadIdx.x; c < f;
       c += (long long)gridDim.x * blockDim.x)
    o[c] = ring_combine(xs[c], xl[c], xr[c], wc, ws);
}

__global__ void ring_mix_kernel_vec4(const float4* __restrict__ x,
                                     float4* __restrict__ out, int n,
                                     long long f4, float wc, float ws) {
  const int i = blockIdx.y;
  const int il = i == 0 ? n - 1 : i - 1, ir = i == n - 1 ? 0 : i + 1;
  const float4* xs = x + (size_t)i * f4;
  const float4* xl = x + (size_t)il * f4;
  const float4* xr = x + (size_t)ir * f4;
  float4* o = out + (size_t)i * f4;
  for (long long c = blockIdx.x * (long long)blockDim.x + threadIdx.x; c < f4;
       c += (long long)gridDim.x * blockDim.x) {
    const float4 a = xs[c], l = xl[c], r = xr[c];
    o[c] = make_float4(ring_combine(a.x, l.x, r.x, wc, ws),
                       ring_combine(a.y, l.y, r.y, wc, ws),
                       ring_combine(a.z, l.z, r.z, wc, ws),
                       ring_combine(a.w, l.w, r.w, wc, ws));
  }
}

}  // namespace

// x, out: (n, f) contiguous fp32, n <= 65535.
REPRO_API int repro_ring_mix(const float* x, float* out, int n, long long f,
                             float wc, float ws, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int threads = 256;
  const bool vec = f % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const long long cols = vec ? f / 4 : f;
  long long blocks = (cols + threads - 1) / threads;
  if (blocks > 1024) blocks = 1024;
  if (blocks < 1) blocks = 1;
  const dim3 grid((unsigned)blocks, n);
  if (vec)
    ring_mix_kernel_vec4<<<grid, threads, 0, st>>>(
        reinterpret_cast<const float4*>(x), reinterpret_cast<float4*>(out), n,
        cols, wc, ws);
  else
    ring_mix_kernel<<<grid, threads, 0, st>>>(x, out, n, f, wc, ws);
  REPRO_LAUNCH_CHECK();
  return 0;
}
