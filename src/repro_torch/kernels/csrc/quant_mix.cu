// One compressed ring gossip hop on a node-stacked int8 payload:
//   out[i] = wc (q[i] s[i]) + ws ((q[i-1] s[i-1]) + (q[i+1] s[i+1])),
// neighbours wrapped mod n, one fp32 scale per node row.
//
// Replaces: src/repro/kernels/quant_mix.py, quant_mix_2d (_quant_mix_kernel),
// the fused dequantize + 3-way combine of (rows, cols) int8 panels.
//
// Bound on the H100: bytes.  1 byte read and 4 bytes written per element
// (plus n scales), against 5 flops; the neighbour rows are read again by the
// blocks of the rows beside them, mostly from L2.
//
// Design: the TPU kernel took the two neighbour payloads as separate inputs
// (the caller rolled them).  Here the kernel reads them by wrapped row
// index, as ring_mix.cu does, so no rolled copies are made: only the int8
// bytes are read.  grid.y is the node row, grid.x strides over the row's
// columns, four columns per thread (a 4-byte load of int8, a 16-byte store)
// where the row length and alignment allow.  Every operation is rounded on
// its own (__fmul_rn / __fadd_rn, so nvcc contracts nothing into an FMA) in
// the association of the TPU kernel and of the plain version, so the result
// is bitwise the plain  wc*dq(q) + ws*(dq(roll(q, 1)) + dq(roll(q, -1))).
#include "common.cuh"

namespace {

__device__ __forceinline__ float quant_combine(float qc, float sc, float ql,
                                               float sl, float qr, float sr,
                                               float wc, float ws) {
  return ring_combine(__fmul_rn(qc, sc), __fmul_rn(ql, sl), __fmul_rn(qr, sr),
                      wc, ws);
}

__global__ void quant_mix_kernel(const int8_t* __restrict__ q,
                                 const float* __restrict__ s,
                                 float* __restrict__ out, int n, long long f,
                                 float wc, float ws) {
  const int i = blockIdx.y;
  const int il = i == 0 ? n - 1 : i - 1, ir = i == n - 1 ? 0 : i + 1;
  const int8_t* qs = q + (size_t)i * f;
  const int8_t* ql = q + (size_t)il * f;
  const int8_t* qr = q + (size_t)ir * f;
  const float sc = s[i], sl = s[il], sr = s[ir];
  float* o = out + (size_t)i * f;
  for (long long c = blockIdx.x * (long long)blockDim.x + threadIdx.x; c < f;
       c += (long long)gridDim.x * blockDim.x)
    o[c] = quant_combine((float)qs[c], sc, (float)ql[c], sl, (float)qr[c], sr,
                         wc, ws);
}

__global__ void quant_mix_kernel_vec4(const char4* __restrict__ q,
                                      const float* __restrict__ s,
                                      float4* __restrict__ out, int n,
                                      long long f4, float wc, float ws) {
  const int i = blockIdx.y;
  const int il = i == 0 ? n - 1 : i - 1, ir = i == n - 1 ? 0 : i + 1;
  const char4* qs = q + (size_t)i * f4;
  const char4* ql = q + (size_t)il * f4;
  const char4* qr = q + (size_t)ir * f4;
  const float sc = s[i], sl = s[il], sr = s[ir];
  float4* o = out + (size_t)i * f4;
  for (long long c = blockIdx.x * (long long)blockDim.x + threadIdx.x; c < f4;
       c += (long long)gridDim.x * blockDim.x) {
    const char4 a = qs[c], l = ql[c], r = qr[c];
    o[c] = make_float4(
        quant_combine((float)a.x, sc, (float)l.x, sl, (float)r.x, sr, wc, ws),
        quant_combine((float)a.y, sc, (float)l.y, sl, (float)r.y, sr, wc, ws),
        quant_combine((float)a.z, sc, (float)l.z, sl, (float)r.z, sr, wc, ws),
        quant_combine((float)a.w, sc, (float)l.w, sl, (float)r.w, sr, wc, ws));
  }
}

}  // namespace

// q: (n, f) contiguous int8; s: (n,) fp32 scales; out: (n, f) fp32;
// n <= 65535.
REPRO_API int repro_quant_mix(const int8_t* q, const float* s, float* out,
                              int n, long long f, float wc, float ws,
                              void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int threads = 256;
  const bool vec = f % 4 == 0 && reinterpret_cast<uintptr_t>(q) % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const long long cols = vec ? f / 4 : f;
  long long blocks = (cols + threads - 1) / threads;
  if (blocks > 1024) blocks = 1024;
  if (blocks < 1) blocks = 1;
  const dim3 grid((unsigned)blocks, n);
  if (vec)
    quant_mix_kernel_vec4<<<grid, threads, 0, st>>>(
        reinterpret_cast<const char4*>(q), s, reinterpret_cast<float4*>(out),
        n, cols, wc, ws);
  else
    quant_mix_kernel<<<grid, threads, 0, st>>>(q, s, out, n, f, wc, ws);
  REPRO_LAUNCH_CHECK();
  return 0;
}
