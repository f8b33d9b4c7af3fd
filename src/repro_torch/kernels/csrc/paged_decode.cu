// One decode step for every slot of a paged KV pool: each slot's single
// query token attends over the pages its block-table row names.
//
// Replaces: src/repro/kernels/paged_decode.py, paged_decode_shgd
// (_paged_kernel), the attention of every layer of every decode wave of the
// serving engine.  Pools (P, ps, Hkv, hd/hdv), block table (S, M) int32
// with -1 for an unallocated page (read as the dump page 0 and masked),
// seq_lens (S,) int32 valid tokens with the query at seq_len - 1; a slot
// with seq_len 0 writes exact zeros.  fp32 or bf16 in, fp32 accumulation.
//
// Bound on the H100: bytes.  Each valid page is read once for the G query
// heads that share its kv head (4 (hd + hdv) flops per key and head against
// (hd + hdv) * 4 bytes per key in fp32: about G flops per byte).
//
// Design: one block per (kv head, slot) holding all G query heads of the
// group, so each page is read once for G heads, as on the TPU.  The TPU
// kernel got the block table and seq_lens as scalar prefetch for its
// index maps; here the block reads its own table row and seq_len, clamps
// -1 to page 0, and walks the slot's tokens in tiles of BK keys (several
// pages) through the table inside the block, with the online softmax of
// attention.cuh.  It stops at the last valid token, and with a window
// starts at the page holding seq_len - window: the positions it skips are
// masked and would add exactly nothing to (m, l, acc).  The tile's page
// lookups are done once per key (its source row, in shared memory), and
// its rows staged with kUnroll loads in flight per thread (attention.cuh),
// not one dependent page lookup and load after another.
#include "attention.cuh"

namespace {

constexpr int kThreads = 128;

template <typename T>
__global__ void __launch_bounds__(kThreads)
    paged_kernel(const T* __restrict__ q, const T* __restrict__ kpages,
                 const T* __restrict__ vpages, const int* __restrict__ table,
                 const int* __restrict__ seq_lens, T* __restrict__ out, int M,
                 int ps, int Hkv, int G, int hd, int hdv, float scale,
                 int window, int BK) {
  extern __shared__ __align__(16) float smem[];
  const attn::Tiles t = attn::carve(smem, G, BK, hd, hdv);
  const int kh = blockIdx.x, slot = blockIdx.y;
  const int H = Hkv * G;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int sl = seq_lens[slot];
  const int* row = table + (size_t)slot * M;

  for (int i = tid; i < G * hd; i += nt) {
    const int r = i / hd, d = i - r * hd;
    t.q[(size_t)r * (hd + 1) + d] =
        attn::to_f32(q[((size_t)slot * H + kh * G + r) * hd + d]) * scale;
  }
  for (int r = tid; r < G; r += nt) t.qp[r] = sl - 1;
  attn::init_state(t, G, hdv);

  const int end = min(sl, M * ps);
  int start = window > 0 ? max(0, sl - window) : 0;
  start -= start % ps;
  for (int p0 = start; p0 < end; p0 += BK) {
    __syncthreads();  // the previous tile is done with k, v and kp
    for (int c = tid; c < BK; c += nt) {
      const int pos = p0 + c;
      t.kp[c] = pos < end ? pos : -1;
      t.row[c] = pos < end ? ((long long)max(row[pos / ps], 0) * ps +
                              pos % ps) * Hkv + kh
                           : -1;
    }
    __syncthreads();
    attn::stage_rows(t.k, hd + 1, kpages, t.row, BK, hd);
    attn::stage_rows(t.v, hdv, vpages, t.row, BK, hdv);
    __syncthreads();
    attn::attend_tile(t, G, BK, hd, hdv, /*causal=*/true, window);
  }
  __syncthreads();
  for (int i = tid; i < G * hdv; i += nt) {
    const int r = i / hdv, j = i - r * hdv;
    out[((size_t)slot * H + kh * G + r) * hdv + j] =
        attn::from_f32<T>(t.acc[i] / fmaxf(t.l[r], 1e-30f));
  }
}

template <typename T>
int launch(const void* q, const void* kpages, const void* vpages,
           const int* table, const int* seq_lens, void* out, int S, int M,
           int ps, int Hkv, int G, int hd, int hdv, float scale, int window,
           cudaStream_t st) {
  static bool smem_set = false;
  const int BK = attn::key_tile(G, hd, hdv);
  if (BK == 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = attn::allow_smem(paged_kernel<T>, &smem_set);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(Hkv, S);
  paged_kernel<T><<<grid, kThreads, attn::smem_bytes(G, BK, hd, hdv), st>>>(
      static_cast<const T*>(q), static_cast<const T*>(kpages),
      static_cast<const T*>(vpages), table, seq_lens, static_cast<T*>(out), M,
      ps, Hkv, G, hd, hdv, scale, window, BK);
  REPRO_LAUNCH_CHECK();
  return 0;
}

}  // namespace

// q (S, Hkv * G, hd), pools (P, ps, Hkv, hd) and (P, ps, Hkv, hdv), out
// (S, Hkv * G, hdv), all contiguous, fp32 (bf16 = 0) or bf16 (bf16 = 1);
// table (S, M) and seq_lens (S,) int32.  hd and hdv <= 256, S <= 65535.
// window <= 0: no window.
REPRO_API int repro_paged_decode(const void* q, const void* kpages,
                                 const void* vpages, const int* table,
                                 const int* seq_lens, void* out, int S, int M,
                                 int ps, int Hkv, int G, int hd, int hdv,
                                 float scale, int window, int bf16,
                                 void* stream) {
  if (hd > attn::kMaxHeadDim || hdv > attn::kMaxHeadDim)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch<__nv_bfloat16>(q, kpages, vpages, table, seq_lens, out, S,
                                 M, ps, Hkv, G, hd, hdv, scale, window, st);
  return launch<float>(q, kpages, vpages, table, seq_lens, out, S, M, ps, Hkv,
                       G, hd, hdv, scale, window, st);
}
