// Fused polar retraction  R_x(P_x(g)) = (x + u)(I + u^T u)^{-1/2},
// u = g - x sym(x^T g), node-batched.
//
// Replaces: src/repro/kernels/retract.py, fused_retract_2d
// (_fused_kernel with _ns_invsqrt; one two-pass pallas_call per leaf).
//
// Same algebra as the TPU kernel.  Because x^T x = I, every (r, r)
// statistic of u follows from two Grams of the inputs:
//   B = x^T g,  C = g^T g,  S = sym(B),  u^T u = C - B^T S - S B + S S,
//   out = x M1 + g M2,  M2 = inv = (I + u^T u)^{-1/2},  M1 = (I - S) inv,
// with inv from the coupled Newton--Schulz iteration (inf-norm scaling,
// ns_iters iterations, as geometry/stiefel.py does).
//
// Bound on the H100: operations.  At the fair fc1 shape (20, 784, 64) one
// call is 2 x 2 d r^2 flops of Grams plus 2 x 2 d r^2 of apply per node and
// ns_iters x 3 products of 2 r^3 flops; 12 MB of unique bytes.  The
// Newton--Schulz chain is sequential: 60 dependent (r, r) products per node.
//
// Design: three launches instead of the TPU's one.
//   1. gram_partial_kernel<TWO>: B and C partials over d chunks (both Grams
//      share the loaded g tile).
//   2. finalize_kernel: one block per node adds the partials in a fixed
//      order and runs the whole (r, r) stage - S, u^T u, the scaling, the
//      Newton--Schulz loop, M1 and M2 - in shared memory (six r x r fp32
//      matrices: 96 KB at r = 64).  Where six matrices exceed the 227 KB a
//      block may use (r > 98) the same code runs on a global scratch buffer.
//   3. apply_kernel<kApplyRetract>: out = x M1 + g M2.
// fp32 FMA on CUDA cores throughout, no TF32 (TF32 breaks the 5e-5 gate).
#include "tall.cuh"

namespace {

// C = op(A) B for row-major (r, r) matrices, op(A) = A^T when TA; all
// threads of the block take part.  C must not alias A or B.  The caller
// synchronizes before (inputs written) and after (outputs read).
template <bool TA>
__device__ void block_mm(const float* A, const float* B, float* C, int r) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  for (int i0 = 0; i0 < r; i0 += tall::kTile)
    for (int j0 = 0; j0 < r; j0 += tall::kTile) {
      float acc[4][4] = {};
      for (int k = 0; k < r; ++k) {
        float a[4], v[4];
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          const int i = i0 + ty + 16 * t, j = j0 + tx + 16 * t;
          a[t] = i < r ? (TA ? A[(size_t)k * r + i] : A[(size_t)i * r + k]) : 0.f;
          v[t] = j < r ? B[(size_t)k * r + j] : 0.f;
        }
#pragma unroll
        for (int s = 0; s < 4; ++s)
#pragma unroll
          for (int t = 0; t < 4; ++t) acc[s][t] = fmaf(a[s], v[t], acc[s][t]);
      }
#pragma unroll
      for (int s = 0; s < 4; ++s)
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          const int i = i0 + ty + 16 * s, j = j0 + tx + 16 * t;
          if (i < r && j < r) C[(size_t)i * r + j] = acc[s][t];
        }
    }
}

// One block per node.  pb/pc: (batch, n_chunks, r, r) partial Grams;
// m1/m2: (batch, r, r) outputs; scratch: (batch, 6, r, r) when !use_smem.
__global__ void __launch_bounds__(tall::kThreads)
finalize_kernel(const float* __restrict__ pb, const float* __restrict__ pc,
                float* __restrict__ m1, float* __restrict__ m2,
                float* scratch, int r, int n_chunks, int ns_iters,
                int use_smem) {
  extern __shared__ float smem[];
  __shared__ float red[tall::kThreads];
  const int b = blockIdx.x, tid = threadIdx.x;
  const size_t rr = (size_t)r * r;
  float* w = use_smem ? smem : scratch + (size_t)b * 6 * rr;
  float* bm = w;            // B, later Z
  float* a = w + rr;        // C, then A = I + u^T u, then Y
  float* s = w + 2 * rr;    // S
  float* t = w + 3 * rr;    // B^T S, then T
  float* u = w + 4 * rr;    // S S, then Y_new
  float* v = w + 5 * rr;    // Z_new

  const float* pbb = pb + (size_t)b * n_chunks * rr;
  const float* pcb = pc + (size_t)b * n_chunks * rr;
  for (size_t e = tid; e < rr; e += blockDim.x) {
    float sb = 0.f, sc = 0.f;
    for (int c = 0; c < n_chunks; ++c) {
      sb += pbb[c * rr + e];
      sc += pcb[c * rr + e];
    }
    bm[e] = sb;
    a[e] = sc;
  }
  __syncthreads();
  for (size_t e = tid; e < rr; e += blockDim.x) {
    const int i = e / r, j = e % r;
    s[e] = 0.5f * (bm[(size_t)i * r + j] + bm[(size_t)j * r + i]);
  }
  __syncthreads();
  block_mm<true>(bm, s, t, r);     // B^T S
  block_mm<false>(s, s, u, r);     // S S
  __syncthreads();
  // A = I + u^T u,  u^T u = C - B^T S - (B^T S)^T + S S
  for (size_t e = tid; e < rr; e += blockDim.x) {
    const int i = e / r, j = e % r;
    const float utu = ((a[e] - t[e]) - t[(size_t)j * r + i]) + u[e];
    a[e] = (i == j ? 1.f : 0.f) + utu;
  }
  __syncthreads();
  // c = max_i sum_j |A_ij| + 1e-6  (inf-norm bound on the spectrum)
  float row_max = 0.f;
  for (int i = tid; i < r; i += blockDim.x) {
    float acc = 0.f;
    for (int j = 0; j < r; ++j) acc += fabsf(a[(size_t)i * r + j]);
    row_max = fmaxf(row_max, acc);
  }
  red[tid] = row_max;
  __syncthreads();
  for (int half = blockDim.x / 2; half > 0; half /= 2) {
    if (tid < half) red[tid] = fmaxf(red[tid], red[tid + half]);
    __syncthreads();
  }
  const float c = red[0] + 1e-6f;
  for (size_t e = tid; e < rr; e += blockDim.x) {
    const int i = e / r, j = e % r;
    a[e] = a[e] / c;                  // Y_0 = A / c
    bm[e] = i == j ? 1.f : 0.f;       // Z_0 = I
  }
  __syncthreads();
  float* y = a;
  float* z = bm;
  for (int it = 0; it < ns_iters; ++it) {
    block_mm<false>(z, y, t, r);
    __syncthreads();
    for (size_t e = tid; e < rr; e += blockDim.x) {
      const int i = e / r, j = e % r;
      t[e] = 0.5f * ((i == j ? 3.f : 0.f) - t[e]);
    }
    __syncthreads();
    block_mm<false>(y, t, u, r);     // Y_new = Y T
    block_mm<false>(t, z, v, r);     // Z_new = T Z
    __syncthreads();
    float* tmp = y; y = u; u = tmp;
    tmp = z; z = v; v = tmp;
  }
  // inv = Z / sqrt(c);  M2 = inv;  M1 = (I - S) inv
  const float rs = 1.f / sqrtf(c);
  float* m1b = m1 + (size_t)b * rr;
  float* m2b = m2 + (size_t)b * rr;
  for (size_t e = tid; e < rr; e += blockDim.x) {
    const int i = e / r, j = e % r;
    const float inv = z[e] * rs;
    u[e] = inv;
    m2b[e] = inv;
    t[e] = (i == j ? 1.f : 0.f) - s[e];
  }
  __syncthreads();
  block_mm<false>(t, u, m1b, r);
}

}  // namespace

// Bytes of shared memory a block may use on sm_90 (dynamic, after opt-in).
constexpr int kMaxSmem = 232448;

// x, g, out: (batch, d, r); pb, pc: (batch, n_chunks, r, r);
// m1, m2: (batch, r, r); scratch: (batch, 6, r, r), used when the six
// matrices and the reduction buffer exceed kMaxSmem (may be null otherwise).
REPRO_API int repro_fused_retract(const float* x, const float* g, float* out,
                                  float* pb, float* pc, float* m1, float* m2,
                                  float* scratch, int batch, int d, int r,
                                  int chunk, int n_chunks, int ns_iters,
                                  void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int tiles = tall::ceil_div(r, tall::kTile);
  tall::gram_partial_kernel<true>
      <<<dim3(tiles * tiles, n_chunks, batch), tall::kThreads, 0, st>>>(
          x, g, pb, pc, d, r, chunk);
  REPRO_LAUNCH_CHECK();
  const size_t smem = (size_t)6 * r * r * sizeof(float);
  const int use_smem =
      smem + sizeof(float) * tall::kThreads <= (size_t)kMaxSmem;
  if (use_smem) {
    cudaError_t err = cudaFuncSetAttribute(
        finalize_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  } else if (scratch == nullptr) {
    return (int)cudaErrorInvalidValue;
  }
  finalize_kernel<<<batch, tall::kThreads, use_smem ? smem : 0, st>>>(
      pb, pc, m1, m2, scratch, r, n_chunks, ns_iters, use_smem);
  REPRO_LAUNCH_CHECK();
  tall::apply_kernel<tall::kApplyRetract>
      <<<dim3(tall::ceil_div(d, tall::kTile) * tiles, 1, batch),
         tall::kThreads, 0, st>>>(x, g, m1, m2, out, d, r);
  REPRO_LAUNCH_CHECK();
  return 0;
}
