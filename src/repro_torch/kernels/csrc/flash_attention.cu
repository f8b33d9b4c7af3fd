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
// unmasked (query, key) pair against 2 hd bytes per query row), bytes for
// decode (one query row against the whole cache).  The operations go to
// the tensor cores: bf16 products at 989 TFLOP/s, fp32 products as
// 3xTF32 (each operand split into a TF32 high part and a TF32 residual,
// three products per fp32 product) at 495 / 3 = 165 TFLOP/s, which keeps
// fp32 accuracy; plain TF32 keeps three digits and would miss the fp32
// gate.
//
// Design, the tensor-core route (hd and hdv multiples of 16, at most 128,
// 16-byte aligned operands), FlashAttention-2 style: one block of 4 warps
// per (query tile, head, batch row), each warp owning 16 query rows.
// A warp keeps its scaled q tile in registers as mma.sync A fragments;
// the scores of a key tile come out of mma.sync in registers, the online
// softmax (row max, exp2, the correction of acc) runs there with quad
// shuffles, and the probabilities become the A operand of the P @ V
// product in place: in bf16 through the fragment layouts of m16n8k16, in
// fp32 by reading the keys of each k8 step in the order the score
// fragment holds them (key 2t as k-index t, key 2t + 1 as t + 4), which
// the matching V rows follow.  Neither the scores nor acc go through
// shared memory; m and l live per row in registers (l as per-thread
// partial sums, added across the quad at the end).  K and V tiles move
// with 16-byte cp.async into a two-stage ring, the next round's tiles
// loading while a round computes; rows are padded by 16 bytes, so the
// B-fragment loads (ldmatrix for bf16 K and, transposed, V) hit distinct
// banks.  The card spends a tile's time issuing instructions, not waiting
// on the tensor cores, so the tile step is kept short: a tile whose key
// positions every row of the warp may use skips the mask, exp2 runs on
// the special-function unit (ex2.approx, 2^-inf = 0), and the staging's
// addresses are one 64-bit base per tile.  Query rows per block fall from
// 64 to 32 to 16 while the grid would leave SMs empty, and the warps freed
// split the keys of the same rows: each takes every 2nd or 4th used tile
// and the warps of a row group merge (m, l, acc) in a fixed order at the
// end (S=256, H=9, B=1: 144 blocks of 16 rows, 4 warps on the keys of
// each; a block's chain of tiles is a quarter as long).
//
// bf16 keeps the reference's fp32 arithmetic (q * scale and P in fp32):
// the raw bf16 q is exact as an A fragment and scale * log2(e) multiplies
// the fp32 scores after the product, and P goes to P @ V as a bf16 high
// part plus a bf16 residual, two products into the same fp32 acc (P to
// about 2^-17 relative, as 3xTF32 does for fp32).  One rounding of P
// (2^-9 relative on each weight, while l sums the unrounded ones) moves
// the output by up to about |out| * 2^-10, which with the output's own
// bf16 rounding passes the 2e-2 gate once |out| nears 8.
//
// Where the caller asks (the gradient under autograd), either route also
// writes each query row's log-sum-exp of its scaled scores (natural log,
// (B, H, S) fp32), so the backward kernel (flash_attention_bwd.cu)
// recomputes q.k only twice per (query, key, head) and not three times.
//
// Kept from the first version: the kv head is h / (H / Hkv), so K and V
// are read in place for every query head of a group; q, k, v stay in the
// public (B, S, H, hd) layout and the kernel masks the ragged S and T
// edges; a masked score is -inf and m starts at -1e30, so a masked
// probability is exactly 0 and rows without keys write exact zeros; a key
// tile that no query row of the block may use is skipped (each warp finds
// the used tiles by itself from the positions, 512 keys per round of
// loads, so the skip needs no barrier).  Blocks start from the last query
// rows, which have the most keys under a causal mask.
//
// The SIMT route, for the other shapes (hd or hdv not a multiple of 16,
// above 128, or misaligned operands), is the first version: fp32 products
// on CUDA cores from shared memory.  The route is chosen by shape in the
// C entry point; either way the call is one launch.
#include <algorithm>
#include <cfloat>
#include <climits>

#include "attention.cuh"

namespace {

// ---------------------------------------------------------------------------
// SIMT route
// ---------------------------------------------------------------------------
namespace simt {

constexpr int kThreads = 256;

// Shared-memory layout of one block.  Rows of q and k are padded to hd + 1
// floats and rows of s to BK + 1, so that threads reading one column of
// consecutive rows hit distinct banks.
struct Tiles {
  long long* row;  // BK: source row of each key (-1: none), see stage_rows
  float* q;     // R x (hd + 1), scaled
  float* k;     // BK x (hd + 1)
  float* v;     // BK x hdv
  float* s;     // R x (BK + 1): scores, then probabilities
  float* acc;   // R x hdv
  float* m;     // R
  float* l;     // R
  float* corr;  // R
  int* qp;      // R query positions
  int* kp;      // BK key positions (-1: no key)
};

inline size_t smem_bytes(int R, int BK, int hd, int hdv) {
  const size_t floats = (size_t)R * (hd + 1) + (size_t)BK * (hd + 1) +
                        (size_t)BK * hdv + (size_t)R * (BK + 1) +
                        (size_t)R * hdv + 3 * (size_t)R;
  return (size_t)BK * sizeof(long long) + floats * sizeof(float) +
         (size_t)(R + BK) * sizeof(int);
}

// Key-tile rows BK for R query rows: 64, halved while the block's shared
// memory would exceed the card's limit.  Returns 0 if even 8 do not fit.
inline int key_tile(int R, int hd, int hdv) {
  for (int bk = 64; bk >= 8; bk /= 2)
    if (smem_bytes(R, bk, hd, hdv) <= attn::kMaxSmem) return bk;
  return 0;
}

__device__ inline Tiles carve(float* base, int R, int BK, int hd, int hdv) {
  Tiles t;
  t.row = reinterpret_cast<long long*>(base);
  t.q = reinterpret_cast<float*>(t.row + BK);
  t.k = t.q + (size_t)R * (hd + 1);
  t.v = t.k + (size_t)BK * (hd + 1);
  t.s = t.v + (size_t)BK * hdv;
  t.acc = t.s + (size_t)R * (BK + 1);
  t.m = t.acc + (size_t)R * hdv;
  t.l = t.m + R;
  t.corr = t.l + R;
  t.qp = reinterpret_cast<int*>(t.corr + R);
  t.kp = t.qp + R;
  return t;
}

// Stages the BK rows of one key tile, row c from src + row[c] * width
// (zeros where row[c] < 0), into dst with row stride ld, converted to fp32.
// Every thread starts kUnroll independent loads before it stores any.
constexpr int kUnroll = 8;

template <typename T>
__device__ inline void stage_rows(float* dst, int ld,
                                  const T* __restrict__ src,
                                  const long long* row, int BK, int width) {
  const int n = BK * width;
  for (int base = threadIdx.x; base < n; base += blockDim.x * kUnroll) {
    float x[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = base + u * blockDim.x;
      const int c = i / width;
      x[u] = i < n && row[c] >= 0
                 ? attn::to_f32(src[row[c] * width + (i - c * width)])
                 : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = base + u * blockDim.x;
      const int c = i / width;
      if (i < n) dst[c * ld + (i - c * width)] = x[u];
    }
  }
}

// dot(a, b) over n floats in shared memory, four partial sums in flight.
__device__ __forceinline__ float dot4(const float* a, const float* b, int n,
                                      int b_stride) {
  float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
  int d = 0;
  for (; d + 4 <= n; d += 4) {
    s0 = fmaf(a[d], b[d * b_stride], s0);
    s1 = fmaf(a[d + 1], b[(d + 1) * b_stride], s1);
    s2 = fmaf(a[d + 2], b[(d + 2) * b_stride], s2);
    s3 = fmaf(a[d + 3], b[(d + 3) * b_stride], s3);
  }
  for (; d < n; ++d) s0 = fmaf(a[d], b[d * b_stride], s0);
  return (s0 + s1) + (s2 + s3);
}

// One key tile: q, qp, k, v and kp are staged; updates (m, l, acc).  Ends
// without a barrier: the caller synchronizes before it overwrites k, v, kp.
__device__ inline void attend_tile(const Tiles& t, int R, int BK, int hd,
                                   int hdv, bool causal, int window) {
  const int tid = threadIdx.x, nt = blockDim.x;
  for (int i = tid; i < R * BK; i += nt) {
    const int r = i / BK, c = i - r * BK;
    const float dot = dot4(t.q + (size_t)r * (hd + 1),
                           t.k + (size_t)c * (hd + 1), hd, 1);
    t.s[r * (BK + 1) + c] =
        attn::usable(t.qp[r], t.kp[c], causal, window) ? dot : attn::kNegInf;
  }
  __syncthreads();
  const int warp = tid >> 5, lane = tid & 31, nw = nt >> 5;
  for (int r = warp; r < R; r += nw) {
    float* sr = t.s + r * (BK + 1);
    float mx = attn::kNegInf;
    for (int c = lane; c < BK; c += 32) mx = fmaxf(mx, sr[c]);
    mx = attn::warp_max(mx);
    const float m_prev = t.m[r];
    const float m_new = fmaxf(m_prev, mx);
    const int qp = t.qp[r];
    float sum = 0.f;
    for (int c = lane; c < BK; c += 32) {
      const float p = attn::usable(qp, t.kp[c], causal, window)
                          ? expf(sr[c] - m_new)
                          : 0.f;
      sr[c] = p;
      sum += p;
    }
    sum = attn::warp_sum(sum);
    if (lane == 0) {
      const float corr = expf(m_prev - m_new);
      t.corr[r] = corr;
      t.l[r] = t.l[r] * corr + sum;
      t.m[r] = m_new;
    }
  }
  __syncthreads();
  for (int i = tid; i < R * hdv; i += nt) {
    const int r = i / hdv, j = i - r * hdv;
    const float a = dot4(t.s + r * (BK + 1), t.v + j, BK, hdv);
    t.acc[i] = t.acc[i] * t.corr[r] + a;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const int* __restrict__ qpos,
                 const int* __restrict__ kpos, T* __restrict__ out,
                 float* __restrict__ lse, int S, int Tk, int H, int Hkv,
                 int hd, int hdv, float scale, bool causal, int window, int R,
                 int BK) {
  extern __shared__ __align__(16) float smem[];
  const Tiles t = carve(smem, R, BK, hd, hdv);
  const int b = blockIdx.z, h = blockIdx.y, s0 = blockIdx.x * R;
  const int kh = h / (H / Hkv);
  const int tid = threadIdx.x, nt = blockDim.x;
  const int rows = min(R, S - s0);

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
  for (int i = tid; i < R * hdv; i += nt) t.acc[i] = 0.f;
  for (int r = tid; r < R; r += nt) {
    t.m[r] = attn::kNegInf;
    t.l[r] = 0.f;
  }
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
      any |= kp >= 0 && (!causal || kp <= qmax) &&
             (window <= 0 || qmin - kp < window);
    }
    if (!__syncthreads_or(any)) continue;
    stage_rows(t.k, hd + 1, k, t.row, BK, hd);
    stage_rows(t.v, hdv, v, t.row, BK, hdv);
    __syncthreads();
    attend_tile(t, R, BK, hd, hdv, causal, window);
  }
  __syncthreads();
  for (int i = tid; i < rows * hdv; i += nt) {
    const int r = i / hdv, j = i - r * hdv;
    out[(((size_t)b * S + s0 + r) * H + h) * hdv + j] =
        attn::from_f32<T>(t.acc[i] / fmaxf(t.l[r], 1e-30f));
  }
  if (lse != nullptr)
    for (int r = tid; r < rows; r += nt)
      lse[((size_t)b * H + h) * S + s0 + r] =
          t.m[r] + logf(fmaxf(t.l[r], FLT_MIN));
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const int* qpos,
           const int* kpos, void* out, float* lse, int B, int S, int Tk,
           int H, int Hkv, int hd, int hdv, float scale, int causal,
           int window, cudaStream_t st) {
  static bool smem_set = false;
  // query rows per block: the smallest power of two >= S, at most 64
  int R = 64;
  while (R > 1 && R / 2 >= S) R /= 2;
  int BK;
  while ((BK = key_tile(R, hd, hdv)) == 0 && R > 1) R /= 2;
  if (BK == 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = attn::allow_smem(flash_kernel<T>, &smem_set);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((S + R - 1) / R, H, B);
  flash_kernel<T><<<grid, kThreads, smem_bytes(R, BK, hd, hdv), st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), qpos, kpos, static_cast<T*>(out), lse, S, Tk,
      H, Hkv, hd, hdv, scale, causal != 0, window, R, BK);
  REPRO_LAUNCH_CHECK();
  return 0;
}

}  // namespace simt

// ---------------------------------------------------------------------------
// Tensor-core route
// ---------------------------------------------------------------------------
namespace tc {

constexpr int kMaxWarps = 4;
constexpr int kSms = 132;  // H100 SXM
constexpr float kLog2e = 1.4426950408889634f;

// 3xTF32 products (tensorcore.cuh)
using tcore::mma_3xtf32;
using tcore::split;

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}
// (x0, x1) = hi + lo to about 2^-17 relative, both packed bf16 pairs
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(x0 - hf.x, x1 - hf.y);
}
// 2^x on the special-function unit (flushes denormals; 2^-inf = 0)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}
// four 8x8 bf16 matrices: the B fragments of two n8 tiles
__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* row) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(row));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}
// the same, transposed
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r,
                                                  const void* row) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(row));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// Per dtype: key-tile rows, the k extent of one MMA, the row padding.
template <typename T>
struct Cfg;
template <>
struct Cfg<float> {
  static constexpr int kBN = 32;
  static constexpr int kKS = 8;
};
template <>
struct Cfg<__nv_bfloat16> {
  static constexpr int kBN = 64;
  static constexpr int kKS = 16;
};

// D: hd and hdv padded up to 32, 64 or 128 (the padding is zero-filled).
template <typename T, int D>
struct Layout {
  static constexpr int BN = Cfg<T>::kBN;
  static constexpr int LD = D + 16 / (int)sizeof(T);  // row stride, elements
  static constexpr int kStage = 2 * BN * LD;          // K then V, elements
};

// Which key tiles some row of the block may use (a superset of the exact
// test), for a window of kWin keys at a time: one round of loads from the
// positions serves 512 / BN tiles.  Every warp keeps its own copy and
// computes it from the same data, so all warps agree without a barrier.
struct TileScan {
  static constexpr int kWin = 512;
  int first = 0;      // the window's first tile
  int n = 0;          // tiles in the window (0: no window yet)
  unsigned used = 0;  // bit t: tile first + t may be used
};

__device__ __forceinline__ void scan_window(TileScan& w,
                                            const int* __restrict__ kpos,
                                            int Tk, int j, int BN,
                                            bool causal, int window,
                                            int qmin, int qmax) {
  const int lane = threadIdx.x & 31;
  const int key0 = j * BN;
  int kp[TileScan::kWin / 32];
#pragma unroll
  for (int u = 0; u < TileScan::kWin / 32; ++u) {
    const int key = key0 + 32 * u + lane;
    kp[u] = key < Tk ? __ldg(kpos + key) : -1;
  }
  w.first = j;
  w.n = TileScan::kWin / BN;
  w.used = 0;
#pragma unroll
  for (int u = 0; u < TileScan::kWin / 32; ++u) {
    const bool ok = kp[u] >= 0 && (!causal || kp[u] <= qmax) &&
                    (window <= 0 || qmin - kp[u] < window);
    if (__any_sync(0xffffffffu, ok)) w.used |= 1u << (32 * u / BN);
  }
}

// The first key tile at or after tile j that some row of the block may
// use, or ntiles.
__device__ __forceinline__ int next_tile(TileScan& w,
                                         const int* __restrict__ kpos,
                                         int Tk, int j, int ntiles, int BN,
                                         bool causal, int window, int qmin,
                                         int qmax) {
  while (j < ntiles) {
    if (j < w.first || j >= w.first + w.n)
      scan_window(w, kpos, Tk, j, BN, causal, window, qmin, qmax);
    const unsigned m = w.used >> (j - w.first);
    if (m) return j + __ffs(m) - 1;
    j = w.first + w.n;
  }
  return ntiles;
}

// Starts the copies of key tile j (K, V rows and positions) into a stage.
// Row r of the tile is r row strides (Hkv * width elements) past the
// tile's first row; the padding past hd or hdv and the rows past Tk are
// zero-filled.
template <typename T, int D>
__device__ __forceinline__ void stage(T* sm, int* kps, const T* __restrict__ k,
                                      const T* __restrict__ v,
                                      const int* __restrict__ kpos, int b,
                                      int Tk, int Hkv, int kh, int hd,
                                      int hdv, int j) {
  using L = Layout<T, D>;
  constexpr int kVec = 16 / sizeof(T);   // elements per 16-byte piece
  constexpr int kPieces = D / kVec;      // pieces per padded row
  const int t0 = j * L::BN;
  const size_t row0 = ((size_t)b * Tk + t0) * Hkv + kh;
  const T* k0 = k + row0 * hd;
  const T* v0 = v + row0 * hdv;
  for (int i = threadIdx.x; i < 2 * L::BN * kPieces; i += blockDim.x) {
    const bool is_v = i >= L::BN * kPieces;
    const int e = is_v ? i - L::BN * kPieces : i;
    const int r = e / kPieces, c = e % kPieces;
    const int width = is_v ? hdv : hd;
    const bool fill = t0 + r < Tk && c * kVec < width;
    const T* src = (is_v ? v0 : k0) + r * Hkv * width + c * kVec;
    attn::cp_async16(sm + (is_v ? L::BN * L::LD : 0) + r * L::LD + c * kVec,
                     fill ? src : k, fill);
  }
  for (int r = threadIdx.x; r < L::BN; r += blockDim.x) {
    const bool in = t0 + r < Tk;
    const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(kps + r));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
                 "l"(in ? kpos + t0 + r : kpos), "r"(in ? 4 : 0));
  }
}

// Stages in the K/V ring: the next round's tiles load while a round
// computes.
constexpr int kStages = 2;

template <typename T, int D>
__global__ void __launch_bounds__(32 * kMaxWarps)
    flash_tc_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const int* __restrict__ qpos,
                    const int* __restrict__ kpos, T* __restrict__ out,
                    float* __restrict__ lse, int S, int Tk, int H, int Hkv,
                    int hd, int hdv, float scale, bool causal, int window,
                    int WR, int WK) {
  using L = Layout<T, D>;
  constexpr int BN = L::BN, LD = L::LD, KS = Cfg<T>::kKS;
  constexpr int NT = BN / 8;  // n8 tiles of scores per key tile
  constexpr int VT = D / 8;   // n8 tiles of the output
  constexpr bool kBf16 = sizeof(T) == 2;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  int* kps = reinterpret_cast<int*>(sm + kStages * WK * L::kStage);

  const int b = blockIdx.z, h = blockIdx.y;
  const int kh = h / (H / Hkv);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tig = lane & 3;
  // WR warps down the rows, WK warps across the keys of the same rows
  const int wr = warp % WR, wk = warp / WR;
  const int bm = 16 * WR;
  // the last query rows first: under a causal mask they have the most keys,
  // so the longest blocks start first and the short ones fill the tail
  const int s0 = (gridDim.x - 1 - blockIdx.x) * bm;
  const int* qp_b = qpos + (size_t)b * S;
  const int* kp_b = kpos + (size_t)b * Tk;

  // the block's query positions (every warp the same), for the tile skip
  int qmin = INT_MAX, qmax = INT_MIN;
  for (int r = lane; r < bm; r += 32)
    if (s0 + r < S) {
      qmin = min(qmin, qp_b[s0 + r]);
      qmax = max(qmax, qp_b[s0 + r]);
    }
  qmin = __reduce_min_sync(0xffffffffu, qmin);
  qmax = __reduce_max_sync(0xffffffffu, qmax);

  // this thread's two rows (g and g + 8 of the warp's 16)
  const int r0 = s0 + wr * 16 + g, r1 = r0 + 8;
  const int qp0 = qp_b[min(r0, S - 1)], qp1 = qp_b[min(r1, S - 1)];
  // the warp's query positions, for the tiles that need no mask
  const int wq_min = __reduce_min_sync(0xffffffffu, min(qp0, qp1));
  const int wq_max = __reduce_max_sync(0xffffffffu, max(qp0, qp1));
  const float qs = scale * kLog2e;  // scores in log2 units: exp2 below
  // fp32 q is scaled before its split; bf16 q goes in raw (exact) and its
  // scores are scaled in fp32 after the product
  auto qval = [&](int r, int d) -> float {
    return r < S && d < hd
               ? attn::to_f32(q[(((size_t)b * S + r) * H + h) * hd + d]) *
                     (kBf16 ? 1.f : qs)
               : 0.f;
  };
  // q as A fragments: tf32 m16n8k8 (scaled fp32, split per use) or bf16
  // m16n8k16 (raw, packed pairs)
  constexpr int QK = D / KS;
  float qf[kBf16 ? 1 : QK][4];
  uint32_t qb[kBf16 ? QK : 1][4];
#pragma unroll
  for (int kc = 0; kc < QK; ++kc) {
    const int d = kc * KS;
    if constexpr (kBf16) {
      qb[kc][0] = pack_bf16(qval(r0, d + 2 * tig), qval(r0, d + 2 * tig + 1));
      qb[kc][1] = pack_bf16(qval(r1, d + 2 * tig), qval(r1, d + 2 * tig + 1));
      qb[kc][2] = pack_bf16(qval(r0, d + 2 * tig + 8),
                            qval(r0, d + 2 * tig + 9));
      qb[kc][3] = pack_bf16(qval(r1, d + 2 * tig + 8),
                            qval(r1, d + 2 * tig + 9));
    } else {
      qf[kc][0] = qval(r0, d + tig);
      qf[kc][1] = qval(r1, d + tig);
      qf[kc][2] = qval(r0, d + tig + 4);
      qf[kc][3] = qval(r1, d + tig + 4);
    }
  }

  float o[VT][4];
#pragma unroll
  for (int i = 0; i < VT; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  float m0 = attn::kNegInf, m1 = attn::kNegInf, l0 = 0.f, l1 = 0.f;
  const float kMasked = __int_as_float(0xff800000);  // -inf: exp2 gives 0

  // Each round stages the next WK used tiles (one per key warp) while the
  // round before computes: warp wk takes the round's tile wk.
  const int ntiles = (Tk + BN - 1) / BN;
  TileScan scan;
  int cursor = -1;  // the last tile handed out
  auto fill = [&](int bufi, int& mine) -> int {
    int count = 0;
    mine = ntiles;
    for (int kq = 0; kq < WK; ++kq) {
      const int t = next_tile(scan, kp_b, Tk, cursor + 1, ntiles, BN, causal,
                              window, qmin, qmax);
      if (t >= ntiles) {
        cursor = ntiles;
        break;
      }
      cursor = t;
      stage<T, D>(sm + (bufi * WK + kq) * L::kStage,
                  kps + (bufi * WK + kq) * BN, k, v, kp_b, b, Tk, Hkv, kh, hd,
                  hdv, t);
      if (kq == wk) mine = t;
      ++count;
    }
    return count;
  };
  int buf = 0, mine;
  int count = fill(0, mine);
  attn::cp_async_commit();
  while (count > 0) {
    int mine_next;
    const int count_next = fill(buf ^ 1, mine_next);
    attn::cp_async_commit();
    attn::cp_async_wait<1>();
    __syncthreads();
    if (mine < ntiles) {
      const T* ks = sm + (buf * WK + wk) * L::kStage;
      const T* vs = ks + BN * LD;
      const int* kp = kps + (buf * WK + wk) * BN;
      const int t0 = mine * BN;

      // scores of this warp's 16 rows against the tile's BN keys
      float s[NT][4];
#pragma unroll
      for (int n = 0; n < NT; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
      for (int kc = 0; kc < QK; ++kc) {
        if constexpr (kBf16) {
          // keys n8..n8+7 and n8+8..n8+15, dims kc*16 and kc*16+8
          const T* krow = ks + ((lane & 7) + ((lane >> 4) << 3)) * LD +
                          kc * 16 + ((lane >> 3) & 1) * 8;
#pragma unroll
          for (int n = 0; n < NT; n += 2) {
            uint32_t bk[4];
            ldmatrix_x4(bk, krow + n * 8 * LD);
            mma_bf16(s[n], qb[kc], bk[0], bk[1]);
            mma_bf16(s[n + 1], qb[kc], bk[2], bk[3]);
          }
        } else {
          uint32_t ah[4], al[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) split(qf[kc][i], ah[i], al[i]);
#pragma unroll
          for (int n = 0; n < NT; ++n) {
            const float* kr =
                reinterpret_cast<const float*>(ks) + (n * 8 + g) * LD + kc * 8 +
                tig;
            mma_3xtf32(s[n], ah, al, kr[0], kr[4]);
          }
        }
      }

      if constexpr (kBf16) {
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[n][e] *= qs;
      }

      // mask, unless every row of the warp may use every key of the tile
      // (the tile's position range against the warp's), then the online
      // softmax on the fragments (rows g and g + 8)
      int kmin = INT_MAX, kmax = INT_MIN;
      for (int c = lane; c < BN; c += 32) {
        kmin = min(kmin, kp[c]);
        kmax = max(kmax, kp[c]);
      }
      kmin = __reduce_min_sync(0xffffffffu, kmin);
      kmax = __reduce_max_sync(0xffffffffu, kmax);
      const bool whole = t0 + BN <= Tk && kmin >= 0 &&
                         (!causal || kmax <= wq_min) &&
                         (window <= 0 || wq_max - kmin < window);
      if (!whole) {
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int c = n * 8 + 2 * tig + e;
            const bool in = t0 + c < Tk;
            if (!(in && attn::usable(qp0, kp[c], causal, window)))
              s[n][e] = kMasked;
            if (!(in && attn::usable(qp1, kp[c], causal, window)))
              s[n][2 + e] = kMasked;
          }
      }
      float mx0 = kMasked, mx1 = kMasked;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        mx0 = fmaxf(mx0, fmaxf(s[n][0], s[n][1]));
        mx1 = fmaxf(mx1, fmaxf(s[n][2], s[n][3]));
      }
#pragma unroll
      for (int o2 = 1; o2 <= 2; o2 <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, o2));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, o2));
      }
      const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
      const float c0 = fast_exp2(m0 - mn0), c1 = fast_exp2(m1 - mn1);
      m0 = mn0;
      m1 = mn1;
      float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        s[n][0] = fast_exp2(s[n][0] - mn0);
        s[n][1] = fast_exp2(s[n][1] - mn0);
        s[n][2] = fast_exp2(s[n][2] - mn1);
        s[n][3] = fast_exp2(s[n][3] - mn1);
        sum0 += s[n][0] + s[n][1];
        sum1 += s[n][2] + s[n][3];
      }
      l0 = l0 * c0 + sum0;
      l1 = l1 * c1 + sum1;
#pragma unroll
      for (int i = 0; i < VT; ++i) {
        o[i][0] *= c0;
        o[i][1] *= c0;
        o[i][2] *= c1;
        o[i][3] *= c1;
      }

      // acc += P @ V, P straight from the score fragments
      if constexpr (kBf16) {
#pragma unroll
        for (int kk = 0; kk < BN / 16; ++kk) {
          uint32_t ah[4], al[4];
          split_bf16(s[2 * kk][0], s[2 * kk][1], ah[0], al[0]);
          split_bf16(s[2 * kk][2], s[2 * kk][3], ah[1], al[1]);
          split_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1], ah[2], al[2]);
          split_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3], ah[3], al[3]);
          const T* vrow =
              vs + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD +
              (lane >> 4) * 8;
#pragma unroll
          for (int i = 0; i < VT; i += 2) {
            uint32_t bv[4];
            ldmatrix_x4_trans(bv, vrow + i * 8);
            // the residual first: small terms before large, as 3xTF32
            mma_bf16(o[i], al, bv[0], bv[1]);
            mma_bf16(o[i + 1], al, bv[2], bv[3]);
            mma_bf16(o[i], ah, bv[0], bv[1]);
            mma_bf16(o[i + 1], ah, bv[2], bv[3]);
          }
        }
      } else {
#pragma unroll
        for (int kk = 0; kk < NT; ++kk) {
          // k-index t is key 2t, k-index t + 4 is key 2t + 1 of this n8 tile
          uint32_t ah[4], al[4];
          split(s[kk][0], ah[0], al[0]);
          split(s[kk][2], ah[1], al[1]);
          split(s[kk][1], ah[2], al[2]);
          split(s[kk][3], ah[3], al[3]);
          const float* vr = reinterpret_cast<const float*>(vs) +
                            (kk * 8 + 2 * tig) * LD + g;
#pragma unroll
          for (int i = 0; i < VT; ++i)
            mma_3xtf32(o[i], ah, al, vr[i * 8], vr[LD + i * 8]);
        }
      }
    }
    __syncthreads();  // every warp is done with this stage
    mine = mine_next;
    count = count_next;
    buf ^= 1;
  }
  attn::cp_async_wait<0>();

#pragma unroll
  for (int o2 = 1; o2 <= 2; o2 <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, o2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, o2);
  }
  if (WK > 1) {
    // the key warps of a row group merge in a fixed order through shared
    // memory (the stages are free now): warp wk > 0 writes (m, l, acc),
    // warp 0 of the group folds them in as the online softmax does
    float* xs = reinterpret_cast<float*>(smem_raw);
    constexpr int kRec = 16 * (D + 2);  // one warp's record
    __syncthreads();
    if (wk > 0) {
      float* rec = xs + warp * kRec;
#pragma unroll
      for (int i = 0; i < VT; ++i) {
        const int col = i * 8 + 2 * tig;
        rec[g * D + col] = o[i][0];
        rec[g * D + col + 1] = o[i][1];
        rec[(g + 8) * D + col] = o[i][2];
        rec[(g + 8) * D + col + 1] = o[i][3];
      }
      if (tig == 0) {
        rec[16 * D + g] = m0;
        rec[16 * D + g + 8] = m1;
        rec[16 * D + 16 + g] = l0;
        rec[16 * D + 16 + g + 8] = l1;
      }
    }
    __syncthreads();
    if (wk > 0) return;
    for (int kq = 1; kq < WK; ++kq) {
      const float* rec = xs + (wr + kq * WR) * kRec;
      const float mo0 = rec[16 * D + g], mo1 = rec[16 * D + g + 8];
      const float mn0 = fmaxf(m0, mo0), mn1 = fmaxf(m1, mo1);
      const float a0 = fast_exp2(m0 - mn0), b0 = fast_exp2(mo0 - mn0);
      const float a1 = fast_exp2(m1 - mn1), b1 = fast_exp2(mo1 - mn1);
      l0 = l0 * a0 + rec[16 * D + 16 + g] * b0;
      l1 = l1 * a1 + rec[16 * D + 16 + g + 8] * b1;
      m0 = mn0;
      m1 = mn1;
#pragma unroll
      for (int i = 0; i < VT; ++i) {
        const int col = i * 8 + 2 * tig;
        o[i][0] = o[i][0] * a0 + rec[g * D + col] * b0;
        o[i][1] = o[i][1] * a0 + rec[g * D + col + 1] * b0;
        o[i][2] = o[i][2] * a1 + rec[(g + 8) * D + col] * b1;
        o[i][3] = o[i][3] * a1 + rec[(g + 8) * D + col + 1] * b1;
      }
    }
  }
  // the rows' log-sum-exp for the backward (natural log; m is in log2
  // units), where the caller asks for it
  if (lse != nullptr && tig == 0) {
    constexpr float kLn2 = 0.6931471805599453f;
    if (r0 < S)
      lse[((size_t)b * H + h) * S + r0] = (m0 + log2f(fmaxf(l0, FLT_MIN))) * kLn2;
    if (r1 < S)
      lse[((size_t)b * H + h) * S + r1] = (m1 + log2f(fmaxf(l1, FLT_MIN))) * kLn2;
  }
  const float inv0 = 1.f / fmaxf(l0, 1e-30f), inv1 = 1.f / fmaxf(l1, 1e-30f);
#pragma unroll
  for (int i = 0; i < VT; ++i) {
    const int col = i * 8 + 2 * tig;
    if (col >= hdv) continue;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = half ? r1 : r0;
      if (r >= S) continue;
      const float inv = half ? inv1 : inv0;
      T* dst = out + (((size_t)b * S + r) * H + h) * hdv + col;
      const float x0 = o[i][2 * half] * inv, x1 = o[i][2 * half + 1] * inv;
      if constexpr (kBf16) {
        *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(x0, x1);
      } else {
        *reinterpret_cast<float2*>(dst) = make_float2(x0, x1);
      }
    }
  }
}

template <typename T, int D>
int launch_d(const void* q, const void* k, const void* v, const int* qpos,
             const int* kpos, void* out, float* lse, int B, int S, int Tk,
             int H, int Hkv, int hd, int hdv, float scale, int causal,
             int window, cudaStream_t st) {
  using L = Layout<T, D>;
  static bool smem_set = false;
  cudaError_t err = attn::allow_smem(flash_tc_kernel<T, D>, &smem_set);
  if (err != cudaSuccess) return (int)err;
  // 4 warps: down 64 query rows, or, while the grid would leave SMs idle,
  // down 32 or 16 rows with 2 or 4 warps splitting the keys of each row
  // (as many as the stages' shared memory allows)
  int wr = kMaxWarps;
  while (wr > 1 &&
         (long long)((S + 16 * wr - 1) / (16 * wr)) * H * B < kSms)
    wr /= 2;
  int wk = kMaxWarps / wr;
  const size_t tile = L::kStage * sizeof(T) + L::BN * sizeof(int);
  while (wk > 1 && kStages * wk * tile > attn::kMaxSmem) wk /= 2;
  const size_t merge = (size_t)wr * wk * 16 * (D + 2) * sizeof(float);
  const size_t bytes = std::max(kStages * wk * tile, wk > 1 ? merge : 0);
  const dim3 grid((S + 16 * wr - 1) / (16 * wr), H, B);
  flash_tc_kernel<T, D><<<grid, 32 * wr * wk, bytes, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), qpos, kpos, static_cast<T*>(out), lse, S, Tk,
      H, Hkv, hd, hdv, scale, causal != 0, window, wr, wk);
  REPRO_LAUNCH_CHECK();
  return 0;
}

constexpr int kMaxTcDim = 128;

// The tensor-core route takes the shape: head dims multiples of 16 up to
// 128 (the register budget of the q, score and acc fragments), and 16-byte
// aligned operands for cp.async.
inline bool takes(const void* q, const void* k, const void* v,
                  const void* out, int hd, int hdv) {
  return hd % 16 == 0 && hdv % 16 == 0 && hd <= kMaxTcDim &&
         hdv <= kMaxTcDim && attn::aligned16({q, k, v, out});
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const int* qpos,
           const int* kpos, void* out, float* lse, int B, int S, int Tk,
           int H, int Hkv, int hd, int hdv, float scale, int causal,
           int window, cudaStream_t st) {
  const int d = max(hd, hdv);
  if (d <= 32)
    return launch_d<T, 32>(q, k, v, qpos, kpos, out, lse, B, S, Tk, H, Hkv, hd,
                           hdv, scale, causal, window, st);
  if (d <= 64)
    return launch_d<T, 64>(q, k, v, qpos, kpos, out, lse, B, S, Tk, H, Hkv, hd,
                           hdv, scale, causal, window, st);
  return launch_d<T, 128>(q, k, v, qpos, kpos, out, lse, B, S, Tk, H, Hkv, hd,
                          hdv, scale, causal, window, st);
}

}  // namespace tc

template <typename T>
int launch(const void* q, const void* k, const void* v, const int* qpos,
           const int* kpos, void* out, float* lse, int B, int S, int Tk,
           int H, int Hkv, int hd, int hdv, float scale, int causal,
           int window, cudaStream_t st) {
  if (tc::takes(q, k, v, out, hd, hdv))
    return tc::launch<T>(q, k, v, qpos, kpos, out, lse, B, S, Tk, H, Hkv, hd, hdv,
                         scale, causal, window, st);
  return simt::launch<T>(q, k, v, qpos, kpos, out, lse, B, S, Tk, H, Hkv, hd, hdv,
                         scale, causal, window, st);
}

}  // namespace

// 1 if a call with these operands takes the tensor-core route, else 0 (the
// SIMT route); for tests and the smoke run, which check both.  The output
// comes from the caching allocator, whose blocks are 512-byte aligned.
REPRO_API int repro_flash_attention_route(const void* q, const void* k,
                                          const void* v, int hd, int hdv) {
  return tc::takes(q, k, v, q, hd, hdv) ? 1 : 0;
}

// q (B, S, H, hd), k (B, T, Hkv, hd), v (B, T, Hkv, hdv), out (B, S, H, hdv),
// all contiguous, fp32 (bf16 = 0) or bf16 (bf16 = 1); positions (B, S) and
// (B, T) int32.  H % Hkv == 0, hd and hdv <= 256, B and H <= 65535, S >= 1.
// window <= 0: no window.  lse: null, or (B, H, S) fp32 for the rows'
// log-sum-exp of the scaled scores (the backward's P = exp(s - lse); a
// row without keys gets about -1e30).
REPRO_API int repro_flash_attention(const void* q, const void* k,
                                    const void* v, const int* qpos,
                                    const int* kpos, void* out, float* lse,
                                    int B, int S, int Tk, int H, int Hkv,
                                    int hd, int hdv, float scale, int causal,
                                    int window, int bf16, void* stream) {
  if (hd > attn::kMaxHeadDim || hdv > attn::kMaxHeadDim || H % Hkv != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch<__nv_bfloat16>(q, k, v, qpos, kpos, out, lse, B, S, Tk, H, Hkv,
                                 hd, hdv, scale, causal, window, st);
  return launch<float>(q, k, v, qpos, kpos, out, lse, B, S, Tk, H, Hkv, hd, hdv,
                       scale, causal, window, st);
}
