// Online-softmax attention over (B, S, H, hd) queries and (B, T, Hkv, hd)
// keys / (B, T, Hkv, hdv) values, masked by absolute positions.
//
// Replaces: src/repro/kernels/flash_attention.py, flash_attention_bhsd
// (_flash_kernel), the prefill and contiguous-cache decode attention of the
// LM and serving paths: GQA through the kv index map, causal by absolute
// positions with kv position -1 masked, an optional static window, and
// non-causal for cross-attention.  fp32 or bf16 in, fp32 accumulation, the
// output in q's dtype.
//
// Bound on the H100: operations for a long causal prefill (4 hd flops per
// unmasked (query, key) pair against 2 hd bytes per query row in fp32),
// bytes for decode (one query row against the whole cache).  This first
// version runs the products on CUDA cores in fp32 from shared memory
// (attention.cuh); wgmma, TMA and a split over the keys of long caches are
// later work.
//
// Design: one block per (query tile of R rows, query head, batch row).  The
// kv head is h / (H / Hkv), so K and V are read in place for every query
// head of a group and never copied per head.  The kernel reads q, k, v in
// the public (B, S, H, hd) layout (no transposes) and masks the ragged S
// and T edges itself; the TPU wrapper padded to whole blocks only because
// Pallas needs them.  A key tile that no query row of the block may use
// (from the positions, before K and V are loaded) is skipped: it would
// change no bit.  Each tile's rows are staged with kUnroll loads in flight
// per thread (attention.cuh).
#include <climits>

#include "attention.cuh"

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
    flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const int* __restrict__ qpos,
                 const int* __restrict__ kpos, T* __restrict__ out, int S,
                 int Tk, int H, int Hkv, int hd, int hdv, float scale,
                 bool causal, int window, int R, int BK) {
  extern __shared__ __align__(16) float smem[];
  const attn::Tiles t = attn::carve(smem, R, BK, hd, hdv);
  const int b = blockIdx.z, h = blockIdx.y, s0 = blockIdx.x * R;
  const int kh = h / (H / Hkv);
  const int tid = threadIdx.x, nt = blockDim.x;
  const int rows = min(R, S - s0);  // valid query rows of this tile

  for (int i = tid; i < R * hd; i += nt) {
    const int r = i / hd, d = i - r * hd;
    float x = 0.f;
    if (r < rows)
      x = attn::to_f32(q[(((size_t)b * S + s0 + r) * H + h) * hd + d]) *
          scale;
    t.q[(size_t)r * (hd + 1) + d] = x;
  }
  // padding rows repeat the last valid row's position; they are not written
  for (int r = tid; r < R; r += nt)
    t.qp[r] = qpos[(size_t)b * S + s0 + min(r, rows - 1)];
  attn::init_state(t, R, hdv);
  __syncthreads();
  int qmin = INT_MAX, qmax = INT_MIN;
  for (int r = 0; r < rows; ++r) {
    qmin = min(qmin, t.qp[r]);
    qmax = max(qmax, t.qp[r]);
  }

  for (int t0 = 0; t0 < Tk; t0 += BK) {
    __syncthreads();  // the previous tile is done with k, v and kp
    int any = 0;
    for (int c = tid; c < BK; c += nt) {
      const bool in = t0 + c < Tk;
      const int kp = in ? kpos[(size_t)b * Tk + t0 + c] : -1;
      t.kp[c] = kp;
      t.row[c] = in ? ((long long)b * Tk + t0 + c) * Hkv + kh : -1;
      // some row may use this key: a superset of the exact test
      any |= kp >= 0 && (!causal || kp <= qmax) &&
             (window <= 0 || qmin - kp < window);
    }
    if (!__syncthreads_or(any)) continue;
    attn::stage_rows(t.k, hd + 1, k, t.row, BK, hd);
    attn::stage_rows(t.v, hdv, v, t.row, BK, hdv);
    __syncthreads();
    attn::attend_tile(t, R, BK, hd, hdv, causal, window);
  }
  __syncthreads();
  for (int i = tid; i < rows * hdv; i += nt) {
    const int r = i / hdv, j = i - r * hdv;
    out[(((size_t)b * S + s0 + r) * H + h) * hdv + j] =
        attn::from_f32<T>(t.acc[i] / fmaxf(t.l[r], 1e-30f));
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const int* qpos,
           const int* kpos, void* out, int B, int S, int Tk, int H, int Hkv,
           int hd, int hdv, float scale, int causal, int window,
           cudaStream_t st) {
  static bool smem_set = false;
  // query rows per block: the smallest power of two >= S, at most 64
  int R = 64;
  while (R > 1 && R / 2 >= S) R /= 2;
  int BK;
  while ((BK = attn::key_tile(R, hd, hdv)) == 0 && R > 1) R /= 2;
  if (BK == 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = attn::allow_smem(flash_kernel<T>, &smem_set);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((S + R - 1) / R, H, B);
  flash_kernel<T><<<grid, kThreads, attn::smem_bytes(R, BK, hd, hdv), st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), qpos, kpos, static_cast<T*>(out), S, Tk, H,
      Hkv, hd, hdv, scale, causal != 0, window, R, BK);
  REPRO_LAUNCH_CHECK();
  return 0;
}

}  // namespace

// q (B, S, H, hd), k (B, T, Hkv, hd), v (B, T, Hkv, hdv), out (B, S, H, hdv),
// all contiguous, fp32 (bf16 = 0) or bf16 (bf16 = 1); positions (B, S) and
// (B, T) int32.  H % Hkv == 0, hd and hdv <= 256, B and H <= 65535, S >= 1.
// window <= 0: no window.
REPRO_API int repro_flash_attention(const void* q, const void* k,
                                    const void* v, const int* qpos,
                                    const int* kpos, void* out, int B, int S,
                                    int Tk, int H, int Hkv, int hd, int hdv,
                                    float scale, int causal, int window,
                                    int bf16, void* stream) {
  if (hd > attn::kMaxHeadDim || hdv > attn::kMaxHeadDim || H % Hkv != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch<__nv_bfloat16>(q, k, v, qpos, kpos, out, B, S, Tk, H, Hkv,
                                 hd, hdv, scale, causal, window, st);
  return launch<float>(q, k, v, qpos, kpos, out, B, S, Tk, H, Hkv, hd, hdv,
                       scale, causal, window, st);
}
