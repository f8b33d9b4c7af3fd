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
// (hd + hdv) * 4 bytes per key in fp32: about G flops per byte).  A decode
// wave is a few slots of a few hundred keys: one block per (slot, kv head)
// left all but a dozen SMs idle and walked each slot's keys in series.
//
// Design: a split over each slot's keys, combined inside the same launch.
// The keys of every (slot, kv head) are cut into chunks of whole pages (at
// most 64 tokens; the host's split plan, paged_decode.py) and the grid is
// (chunk, kv head, slot), sized from the table's width M, never from
// seq_lens (they live on the card).  A chunk that lies past seq_len or
// before the window's first key loads nothing and publishes an empty
// partial.  Otherwise the block reads its keys' page indices (issued
// beside seq_len, not after it) and moves all of the chunk's K and V rows
// with 16-byte cp.async, every copy in flight at once, q loading behind
// them.  Then each of its two warps finishes its 32 keys alone: a lane
// scores its key against the G query heads (so a page is still read once
// for the whole group), the row max and sum go through shuffles, the
// probabilities reach P @ V by shuffles too (a lane there holds two output
// columns), and the warp writes its partial (m, l, acc) for the G rows to
// scratch.  The last block of a (slot, kv head) to finish -- a
// __threadfence and an atomic ticket per pair -- merges the partials
// in position order (a fixed order, so the result is the same bits run to
// run; the partials' acc loads do not wait on each other), writes
// acc / max(l, 1e-30) and resets its ticket to 0 for the next call.  The
// tickets are a small int32 buffer the wrapper zeroes once per device and
// stream and keeps; the partials come from the caching allocator.  Masked
// keys (past seq_len, before the window, or in a -1 page) have probability
// exactly 0, so empty slots write exact zeros.
#include "attention.cuh"

namespace {

constexpr int kChunk = 64;  // the most keys of one block: one per thread
constexpr int kThreads = kChunk;
constexpr int kWarps = kThreads / 32;  // each publishes its own partial

__host__ __device__ inline int round8(int x) { return (x + 7) / 8 * 8; }

// Row strides (elements) of the staged K and V tiles: padded to 8 and then
// by 16 bytes, so 16-byte row reads of consecutive keys hit distinct banks.
template <typename T>
__host__ __device__ inline int row_stride(int width) {
  return round8(width) + 16 / (int)sizeof(T);
}

// Dynamic shared memory: 16 bytes for the last-block flag, then either the
// chunk's tiles, the scaled q and the keys' source rows or, in the block
// that merges, the partials' m and weights (2 * n_parts * G + G floats).
template <typename T>
inline size_t smem_bytes(int G, int hd, int hdv, int n_parts) {
  const size_t tiles =
      (size_t)kChunk * (row_stride<T>(hd) + row_stride<T>(hdv)) * sizeof(T) +
      (size_t)G * round8(hd) * sizeof(float) +
      (size_t)kChunk * sizeof(long long);
  const size_t merge = (2 * (size_t)n_parts + 1) * G * sizeof(float);
  return 16 + (tiles > merge ? tiles : merge);
}

// 8 elements of a 16-byte aligned row in shared memory, as floats.
__device__ __forceinline__ void load8(const float* p, float* x) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* x) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}

// 2 elements of a row in shared memory (even offset), as floats.
__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// Stages the chunk's rows of one pool (width hd or hdv) into dst: rows
// with src[c] < 0 and the padding up to round8(width) are zeros.
template <typename T>
__device__ inline void stage_rows(T* dst, const T* __restrict__ pool,
                                  const long long* src, int n, int width,
                                  bool vec16) {
  const int ld = row_stride<T>(width), w8 = round8(width);
  if (vec16) {
    constexpr int kVec = 16 / sizeof(T);
    const int pieces = width / kVec;
    for (int i = threadIdx.x; i < n * pieces; i += blockDim.x) {
      const int r = i / pieces, c = i - r * pieces;
      const long long row = src[r];
      attn::cp_async16(dst + r * ld + c * kVec,
                       row >= 0 ? pool + row * width + c * kVec : pool,
                       row >= 0);
    }
    for (int i = threadIdx.x; i < n * (w8 - width); i += blockDim.x) {
      const int r = i / (w8 - width);
      dst[r * ld + width + (i - r * (w8 - width))] = attn::from_f32<T>(0.f);
    }
  } else {
    for (int i = threadIdx.x; i < n * w8; i += blockDim.x) {
      const int r = i / w8, d = i - r * w8;
      const long long row = src[r];
      dst[r * ld + d] = row >= 0 && d < width ? pool[row * width + d]
                                              : attn::from_f32<T>(0.f);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    paged_split_kernel(const T* __restrict__ q, const T* __restrict__ kpages,
                       const T* __restrict__ vpages,
                       const int* __restrict__ table,
                       const int* __restrict__ seq_lens, T* __restrict__ out,
                       float* __restrict__ part, int* __restrict__ tickets,
                       int M, int ps, int Hkv, int G, int hd, int hdv,
                       float scale, int window, int chunk, bool vec16) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ldk = row_stride<T>(hd), ldv = row_stride<T>(hdv);
  const int hq = round8(hd);
  int& last = *reinterpret_cast<int*>(smem_raw);  // no static shared memory
  T* ks = reinterpret_cast<T*>(smem_raw + 16);
  T* vs = ks + kChunk * ldk;
  float* qs = reinterpret_cast<float*>(vs + kChunk * ldv);
  long long* src = reinterpret_cast<long long*>(qs + G * hq);

  const int ch = blockIdx.x, kh = blockIdx.y, slot = blockIdx.z;
  const int nch = gridDim.x, H = Hkv * G, tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int p0 = ch * chunk;
  // the page of this thread's key, loaded beside seq_len (not after it)
  const int page = tid < chunk && p0 + tid < M * ps
                       ? table[(size_t)slot * M + (p0 + tid) / ps]
                       : 0;
  const int sl = seq_lens[slot];
  const int end = min(sl, M * ps);
  const int lo = window > 0 ? max(0, sl - window) : 0;
  const size_t pair = (size_t)slot * Hkv + kh;
  const int psize = G * (hdv + 2);  // a partial: m[G], l[G], acc[G][hdv]
  float* mine = part + (pair * nch + ch) * kWarps * psize;  // one per warp

  if (p0 < end && p0 + chunk > lo) {
    {  // rows past the chunk are zeros too: every warp reads 32 rows
      const int pos = p0 + tid;
      src[tid] = tid < chunk && pos >= lo && pos < end
                     ? ((long long)max(page, 0) * ps + pos % ps) * Hkv + kh
                     : -1;
    }
    __syncthreads();
    stage_rows(ks, kpages, src, kChunk, hd, vec16);
    stage_rows(vs, vpages, src, kChunk, hdv, vec16);
    attn::cp_async_commit();
    // q while K and V are in flight
    for (int i = tid; i < G * hq; i += kThreads) {
      const int r = i / hq, d = i - r * hq;
      qs[i] = d < hd ? attn::to_f32(q[((size_t)slot * H + kh * G + r) * hd +
                                      d]) * scale
                     : 0.f;
    }
    attn::cp_async_wait<0>();
    __syncthreads();

    // Each warp finishes its 32 keys alone and publishes them as a
    // partial: lane c scores key c against the G query heads (four at a
    // time; masked: -inf, so p is exactly 0), the row max and sum go
    // through shuffles, and for P @ V lane c holds two output columns of
    // every 64 while the probabilities come from their keys' lanes.
    const int key = warp * 32 + lane;
    const bool valid = key < chunk && src[key] >= 0;
    const T* kr = ks + key * ldk;
    const T* vw = vs + warp * 32 * ldv;
    float* mw = mine + warp * psize;
    for (int g0 = 0; g0 < G; g0 += 4) {
      float s[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) s[i] = -__int_as_float(0x7f800000);
      if (valid) {
        float a[4] = {0.f, 0.f, 0.f, 0.f};
        for (int d = 0; d < hq; d += 8) {
          float kx[8];
          load8(kr + d, kx);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            if (g0 + i >= G) break;
            float qx[8];
            load8(qs + (g0 + i) * hq + d, qx);
#pragma unroll
            for (int e = 0; e < 8; ++e) a[i] = fmaf(qx[e], kx[e], a[i]);
          }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) s[i] = a[i];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (g0 + i >= G) break;
        const float m = fmaxf(attn::warp_max(s[i]), attn::kNegInf);
        s[i] = expf(s[i] - m);
        const float l = attn::warp_sum(s[i]);
        if (lane == 0) {
          mw[g0 + i] = m;
          mw[G + g0 + i] = l;
        }
      }
      for (int j0 = 0; j0 < hdv; j0 += 64) {  // every lane: the shuffles
        const int j = j0 + 2 * lane;
        const bool in = j < hdv;
        float a[4][2] = {};
        for (int c = 0; c < 32; ++c) {
          const float2 v = in ? load2(vw + c * ldv + j) : make_float2(0.f, 0.f);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float p = __shfl_sync(0xffffffffu, s[i], c);
            a[i][0] = fmaf(p, v.x, a[i][0]);
            a[i][1] = fmaf(p, v.y, a[i][1]);
          }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if (g0 + i >= G || !in) break;
          float* dst = mw + 2 * G + (g0 + i) * hdv + j;
          dst[0] = a[i][0];
          if (j + 1 < hdv) dst[1] = a[i][1];
        }
      }
    }
  } else {
    for (int i = tid; i < kWarps * psize; i += kThreads) {
      // empty partials: m = -1e30, l = 0, acc = 0
      const int k = i % psize;
      mine[i] = k < G ? attn::kNegInf : 0.f;
    }
  }

  // the last block of this (slot, kv head) merges every chunk's partial
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(tickets + pair, 1) == nch - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  // (m, l) of every partial into shared memory (the tiles are done), then
  // per row the max and each partial's weight, in partial order, then the
  // outputs: their loads of the partials' acc do not wait on each other.
  // An empty partial (m = -1e30, l = 0, acc = 0) adds exactly nothing.
  const int np = nch * kWarps;
  const float* parts = part + pair * np * psize;
  float* pm = reinterpret_cast<float*>(smem_raw + 16);  // np x G
  float* pw = pm + np * G;                              // np x G: l, weights
  float* lsum = pw + np * G;                            // G
  for (int i = tid; i < np * G; i += kThreads) {
    const int c = i / G, g = i - c * G;
    pm[i] = __ldcg(parts + (size_t)c * psize + g);
    pw[i] = __ldcg(parts + (size_t)c * psize + G + g);
  }
  __syncthreads();
  for (int g = tid; g < G; g += kThreads) {
    float mx = attn::kNegInf;
    for (int c = 0; c < np; ++c) mx = fmaxf(mx, pm[c * G + g]);
    float l = 0.f;
    for (int c = 0; c < np; ++c) {
      const float w = expf(pm[c * G + g] - mx);
      l = fmaf(pw[c * G + g], w, l);
      pw[c * G + g] = w;
    }
    lsum[g] = fmaxf(l, 1e-30f);
  }
  __syncthreads();
  for (int i = tid; i < G * hdv; i += kThreads) {
    const int g = i / hdv, j = i - g * hdv;
    float acc = 0.f;
    for (int c = 0; c < np; ++c)
      acc = fmaf(__ldcg(parts + (size_t)c * psize + 2 * G + i), pw[c * G + g],
                 acc);
    out[((size_t)slot * H + kh * G + g) * hdv + j] =
        attn::from_f32<T>(acc / lsum[g]);
  }
  if (tid == 0) tickets[pair] = 0;
}

template <typename T>
int launch(const void* q, const void* kpages, const void* vpages,
           const int* table, const int* seq_lens, void* out, float* part,
           int* tickets, int S, int M, int ps, int Hkv, int G, int hd,
           int hdv, float scale, int window, int chunk, int n_chunks,
           cudaStream_t st) {
  static bool smem_set = false;
  const size_t bytes = smem_bytes<T>(G, hd, hdv, n_chunks * kWarps);
  if (chunk < 1 || chunk > kChunk || n_chunks < 1 ||
      (long long)n_chunks * chunk < (long long)M * ps ||
      bytes > attn::kMaxSmem)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = attn::allow_smem(paged_split_kernel<T>, &smem_set);
  if (err != cudaSuccess) return (int)err;
  const bool vec16 = (hd * sizeof(T)) % 16 == 0 &&
                     (hdv * sizeof(T)) % 16 == 0 &&
                     attn::aligned16({kpages, vpages});
  const dim3 grid(n_chunks, Hkv, S);
  paged_split_kernel<T><<<grid, kThreads, bytes, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(kpages),
      static_cast<const T*>(vpages), table, seq_lens, static_cast<T*>(out),
      part, tickets, M, ps, Hkv, G, hd, hdv, scale, window, chunk, vec16);
  REPRO_LAUNCH_CHECK();
  return 0;
}

}  // namespace

// q (S, Hkv * G, hd), pools (P, ps, Hkv, hd) and (P, ps, Hkv, hdv), out
// (S, Hkv * G, hdv), all contiguous, fp32 (bf16 = 0) or bf16 (bf16 = 1);
// table (S, M) and seq_lens (S,) int32.  part: S * Hkv * n_chunks * 2 *
// G * (hdv + 2) floats of scratch (a partial per warp); tickets: S * Hkv
// int32, zero, and zero again when the kernel ends.  Chunks of ``chunk``
// <= 64 tokens, n_chunks * chunk >= M * ps.  hd and hdv <= 256,
// S <= 65535.  window <= 0: none.
REPRO_API int repro_paged_decode(const void* q, const void* kpages,
                                 const void* vpages, const int* table,
                                 const int* seq_lens, void* out, float* part,
                                 int* tickets, int S, int M, int ps, int Hkv,
                                 int G, int hd, int hdv, float scale,
                                 int window, int chunk, int n_chunks,
                                 int bf16, void* stream) {
  if (hd > attn::kMaxHeadDim || hdv > attn::kMaxHeadDim)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch<__nv_bfloat16>(q, kpages, vpages, table, seq_lens, out,
                                 part, tickets, S, M, ps, Hkv, G, hd, hdv,
                                 scale, window, chunk, n_chunks, st);
  return launch<float>(q, kpages, vpages, table, seq_lens, out, part,
                       tickets, S, M, ps, Hkv, G, hd, hdv, scale, window,
                       chunk, n_chunks, st);
}

// The resources of the kernel at G query heads a kv head, head dims hd and
// hdv and n_chunks chunks a slot (paged_decode.py's split_plan), fp32
// (bf16 = 0) or bf16.
REPRO_API int repro_paged_decode_resources(int G, int hd, int hdv,
                                           int n_chunks, int bf16,
                                           ReproResources* out) {
  if (hd > attn::kMaxHeadDim || hdv > attn::kMaxHeadDim || n_chunks < 1)
    return (int)cudaErrorInvalidValue;
  const int parts = n_chunks * kWarps;
  if (bf16)
    return repro_resources(
        &paged_split_kernel<__nv_bfloat16>, kThreads,
        smem_bytes<__nv_bfloat16>(G, hd, hdv, parts), 1, out);
  return repro_resources(&paged_split_kernel<float>, kThreads,
                         smem_bytes<float>(G, hd, hdv, parts), 1, out);
}
