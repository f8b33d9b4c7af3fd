// Stiefel tangent projection  P_x(g) = g - x sym(x^T g), node-batched.
//
// Replaces: src/repro/kernels/stiefel_project.py, stiefel_project_2d
// (_gram_kernel + _apply_kernel, two pallas_calls over a sequential d grid).
//
// Bound on the H100: per node it moves 3 d r floats (read x and g, write
// the result) for 4 d r^2 flops, r / 3 flops per byte.  The fp32 ridge of
// the card is 67 TFLOP/s / 3.35 TB/s = 20 flops per byte, so the fair fc1
// leaf (r = 64, 21 flops per byte) sits on the ridge and the head leaf
// (r = 3) is bound by bytes; both are a few microseconds of work, so at
// these sizes launch latency dominates.
//
// Design: the TPU kernel carried the Gram in VMEM scratch from one
// sequential grid step to the next.  Blocks on the card run in no order, so
// the Gram is split over d into at most 16 chunks that write their own
// (r, r) partials (gram_partial_kernel), one small kernel adds them in a
// fixed order and symmetrizes (sym_reduce_kernel), and the apply kernel
// reads x and g once more.  x and g are read twice in all; the second read
// mostly hits the 50 MB L2 at the fair shapes.  fp32 FMA on CUDA cores, no
// TF32.
#include "tall.cuh"

namespace {

// S[b] = 0.5 (G + G^T),  G = sum over chunks of P[b, c]  (fixed order).
__global__ void sym_reduce_kernel(const float* __restrict__ p,
                                  float* __restrict__ s, int r, int n_chunks) {
  const int b = blockIdx.y;
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= r * r) return;
  const int i = e / r, j = e % r;
  const size_t rr = (size_t)r * r;
  const float* pb = p + (size_t)b * n_chunks * rr;
  float gij = 0.f, gji = 0.f;
  for (int c = 0; c < n_chunks; ++c) {
    gij += pb[c * rr + (size_t)i * r + j];
    gji += pb[c * rr + (size_t)j * r + i];
  }
  s[b * rr + e] = 0.5f * (gij + gji);
}

}  // namespace

// x, g, out: (batch, d, r); partial: (batch, n_chunks, r, r); sym: (batch, r, r).
REPRO_API int repro_stiefel_project(const float* x, const float* g, float* out,
                                    float* partial, float* sym, int batch,
                                    int d, int r, int chunk, int n_chunks,
                                    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int tiles = tall::ceil_div(r, tall::kTile);
  tall::gram_partial_kernel<false>
      <<<dim3(tiles * tiles, n_chunks, batch), tall::kThreads, 0, st>>>(
          x, g, partial, nullptr, d, r, chunk);
  REPRO_LAUNCH_CHECK();
  sym_reduce_kernel<<<dim3(tall::ceil_div(r * r, 256), batch), 256, 0, st>>>(
      partial, sym, r, n_chunks);
  REPRO_LAUNCH_CHECK();
  tall::apply_kernel<tall::kApplyProject>
      <<<dim3(tall::ceil_div(d, tall::kTile) * tiles, 1, batch),
         tall::kThreads, 0, st>>>(x, g, sym, nullptr, out, d, r);
  REPRO_LAUNCH_CHECK();
  return 0;
}
