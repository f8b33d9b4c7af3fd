// The gradient of flash_attention: dq, dk and dv of fp32 GQA attention over
// (B, S, H, hd) queries and (B, T, Hkv, hd) keys / (B, T, Hkv, hdv) values,
// masked by absolute positions, given the forward output and d_out.
//
// Replaces no TPU kernel: the JAX package defines no VJP for its
// pallas_call and differentiates its plain blockwise attention instead.
// The port differentiates flash_attention under torch.func.vmap(grad(...))
// in the LM trainer, and autograd through the plain version would put a
// chain of library ops on that path; this kernel is its backward.  Its
// plain version is ref.attention_backward.
//
// Arithmetic, as the plain version:  P = exp(scale q k^T - lse) on the
// usable keys (0 elsewhere), D = rowsum(d_out * out),
// dS = P * (d_out v^T - D), dq = scale dS k, dk = scale dS^T q summed over
// the query heads of each kv head's group, dv = P^T d_out summed likewise.
// The masks are the forward kernel's: kv position >= 0, causal by
// position, the optional window, and the kv head h / (H / Hkv).  A query
// with no usable key has P = 0: it passes zero gradient.
//
// Bound on the H100: operations.  The gradient needs, per usable (query,
// key) pair and query head, the five products q.k, d_out.v, P^T d_out,
// dS k and dS^T q: 2 (3 hd + 2 hdv) flops, against each operand read once.
// In fp32 they run on the tensor cores as 3xTF32 (tensorcore.cuh) at
// 495 / 3 = 165 TFLOP/s.
//
// Design, the tensor-core route (hd and hdv multiples of 16 up to 128,
// 16-byte aligned operands; namespace tc), FlashAttention-2's backward
// without atomics: every product a 3xTF32 mma.sync.m16n8k8, operand tiles
// staged with 16-byte cp.async into a two-stage ring (rows padded by 4
// floats, so both fragment patterns below hit 32 distinct banks).  lse is
// the forward kernel's side output (flash_attention.cu writes it when the
// gradient asks), so each (query, key, head) computes q.k twice and
// d_out.v twice, against three and two times in the first version, which
// also ran all five products as fp32 FMA on the CUDA cores with 8 threads
// sharing a row.
//   1. tc_dq_kernel: a block per (64 query rows, head, batch row), a warp
//      per 16 rows.  D of its rows (to a (B, H, S) scratch for kernel 2),
//      then over the key tiles of 32 that some row may use: the scores
//      S = q k^T and dP = d_out v^T of the warp's 16 x 32 tile in
//      registers, P and dS there, and dq += dS k with dS straight from the
//      score fragments as the A operand (key 2t as k-index t, 2t + 1 as
//      t + 4, the forward's P V trick).
//   2. tc_dkdv_kernel: a block per (64 keys, query head, batch row), a warp
//      per 16 keys, over the query tiles of 32 that some key may use:
//      S^T = k q^T and dP^T = v d_out^T in registers, P^T and dS^T there,
//      dv += P^T d_out and dk += dS^T q.  One block per query head, not
//      per kv head: a block per kv head walked the group's heads in turn,
//      and at S = T = 2048 under GQA 9:3 that left 96 blocks for 132 SMs,
//      each with three times the work.
//   The card spends a tile waiting on dependent mma.sync and shared-memory
//   loads more than computing, so both kernels are built for latency: the
//   three TF32 passes of a product run over four or more accumulators
//   before the next pass (mma3_row: the mma asm is volatile, so the
//   instructions go out in program order), and where a block's rows see
//   more than 4 tiles of the other operand it has 8 warps in two groups
//   that take alternate tiles (WK = 2) and add their partial sums in a
//   fixed order at the end: the longest chain of tiles a warp walks halves
//   (64 -> 32 at S = T = 2048 causal) and an SM holds twice the warps.
//   Pairing two products' passes (8 accumulators) raised the registers
//   past three blocks an SM and ran slower.
//   3. Under GQA (H != Hkv), tc_group_sum_kernel adds each kv head's
//      per-head dk and dv terms in head order (B T H (hd + hdv) floats of
//      scratch, written once and read once).
//   Each tile's contribution to dq, dk and dv is summed in the mma over its
//   32 keys or queries and added to the running sum in fp32 (a partial per
//   tile): the tensor cores' fp32 accumulation does not round to nearest,
//   and carried over thousands of keys its error would grow with them
//   (tall.cuh).  Sums run in one fixed order and no value is written by
//   two blocks, so results repeat bit for bit.  A tile no row of the block
//   may use (all empty, ahead of the latest query under causal, behind the
//   window) is neither staged nor computed; its terms are exact zeros.  A
//   warp's tile whose every (row, key) is usable skips the mask, and P
//   comes from ex2.approx, as in the forward's softmax.

// The SIMT route (namespace simt), the first version, takes every other
// shape (head dims not multiples of 16, misaligned operands), chosen by
// shape in the C entry point: it computes lse itself (row statistics in
// its dq pass), fp32 on the CUDA cores.  Launches a call: two on the SIMT
// route, two on the tensor-core route, three there under GQA.
#include <algorithm>
#include <cfloat>
#include <climits>

#include <initializer_list>

#include "common.cuh"
#include "tensorcore.cuh"

namespace attn_bwd {

// ---------------------------------------------------------------------------
// SIMT route: 8 threads per row, fp32 FMA on the CUDA cores
// ---------------------------------------------------------------------------
//   1. dq: one block of 256 threads per (32-query tile, head, batch row),
//      8 threads per query row.  A first loop over the key tiles takes
//      the row's online max and sum (the log-sum-exp, lse); D comes from
//      the d_out and out rows; a second loop recomputes P, dS into shared
//      memory, and adds dS k into dq, each thread owning every 8th
//      dimension of its row.  lse and D go to a (B, H, S) scratch for
//      kernel 2.
//   2. dk/dv: one block per (32-key tile, kv head, batch row), 8 threads
//      per key, looping over the group's query heads and the query tiles;
//      P and dS go through shared memory transposed, so each thread adds
//      P^T d_out and dS^T q for its key over every 8th dimension.
// Tiles live in shared memory with rows padded by one float, so the 8
// threads of a row and the 8 rows a warp reads hit distinct banks.  A
// tile whose keys no query of the query tile may use (all empty, all
// ahead of the latest query under causal, or all behind the window) is
// skipped, as its terms are exact zeros.
namespace simt {


constexpr int kTile = 32;        // query rows and keys per tile
constexpr int kThreads = 256;    // 8 threads per row or key
constexpr int kLanes = 8;
constexpr int kMaxDim = 128;     // largest hd and hdv
constexpr int kPerLane = kMaxDim / kLanes;
constexpr float kNegInf = -1e30f;

// sum or max over the 8 consecutive lanes that share a row
__device__ __forceinline__ float lanes_sum(float x) {
#pragma unroll
  for (int off = 4; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

__device__ __forceinline__ float lanes_max(float x) {
#pragma unroll
  for (int off = 4; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ bool usable(int qp, int kp, int causal,
                                       int window) {
  return kp >= 0 && (!causal || kp <= qp) && (window <= 0 || qp - kp < window);
}

// Position bounds of a tile's valid entries: [lo, hi], any = whether one
// exists (an invalid entry holds INT_MIN).
struct Bounds {
  int lo, hi, any;
};

__device__ Bounds tile_bounds(const int* pos, int n, bool key) {
  Bounds b{INT_MAX, INT_MIN, 0};
  for (int i = 0; i < n; ++i) {
    int p = pos[i];
    if (p == INT_MIN || (key && p < 0)) continue;
    b.lo = min(b.lo, p);
    b.hi = max(b.hi, p);
    b.any = 1;
  }
  return b;
}

// false when no (query, key) of the two tiles is usable
__device__ __forceinline__ bool tiles_meet(Bounds q, Bounds k, int causal,
                                           int window) {
  if (!q.any || !k.any) return false;
  if (causal && k.lo > q.hi) return false;
  if (window > 0 && q.lo - k.hi >= window) return false;
  return true;
}

// Copy `rows` rows of `width` floats (global row stride `stride`) into a
// shared tile with row pitch width + 1; rows past `rows` become zeros.
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          int rows, int width,
                                          size_t stride) {
  const int pitch = width + 1;
  for (int i = threadIdx.x; i < kTile * width; i += kThreads) {
    int r = i / width, d = i - r * width;
    dst[r * pitch + d] = r < rows ? src[(size_t)r * stride + d] : 0.f;
  }
}

__device__ __forceinline__ float dot(const float* a, const float* b, int n) {
  float acc = 0.f;
  for (int d = 0; d < n; ++d) acc = fmaf(a[d], b[d], acc);
  return acc;
}

// ---- kernel 1: dq, and the rows' lse and D -------------------------------
__global__ void __launch_bounds__(kThreads)
attn_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, const float* __restrict__ out,
                   const float* __restrict__ dout,
                   const int* __restrict__ qpos, const int* __restrict__ kpos,
                   float* __restrict__ dq, float* __restrict__ lse_out,
                   float* __restrict__ d_out_rows, int S, int T, int H,
                   int Hkv, int hd, int hdv, float scale, int causal,
                   int window) {
  extern __shared__ float smem[];
  const int qp_ = hd + 1, vp_ = hdv + 1;
  float* sQ = smem;                          // [kTile][hd + 1]
  float* sdO = sQ + kTile * qp_;             // [kTile][hdv + 1]
  float* sK = sdO + kTile * vp_;             // [kTile][hd + 1]
  float* sV = sK + kTile * qp_;              // [kTile][hdv + 1]
  float* sdS = sV + kTile * vp_;             // [kTile][kTile + 1]
  int* sQpos = reinterpret_cast<int*>(sdS + kTile * (kTile + 1));
  int* sKpos = sQpos + kTile;
  __shared__ Bounds qb, kb;
  __shared__ int meet;

  const int s0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int rows = min(kTile, S - s0);
  const int t = threadIdx.x, r = t / kLanes, lane = t % kLanes;

  const size_t q_row = (size_t)H * hd, o_row = (size_t)H * hdv;
  const size_t k_row = (size_t)Hkv * hd, v_row = (size_t)Hkv * hdv;
  load_tile(sQ, q + ((size_t)b * S + s0) * q_row + (size_t)h * hd, rows, hd,
            q_row);
  load_tile(sdO, dout + ((size_t)b * S + s0) * o_row + (size_t)h * hdv, rows,
            hdv, o_row);
  if (t < kTile) sQpos[t] = t < rows ? qpos[(size_t)b * S + s0 + t] : INT_MIN;
  __syncthreads();
  if (t == 0) qb = tile_bounds(sQpos, kTile, false);

  // D = rowsum(d_out * out), out read straight from global memory
  float dsum = 0.f;
  if (r < rows) {
    const float* orow = out + ((size_t)b * S + s0 + r) * o_row +
                        (size_t)h * hdv;
    for (int e = lane; e < hdv; e += kLanes)
      dsum = fmaf(sdO[r * vp_ + e], orow[e], dsum);
  }
  const float D = lanes_sum(dsum);
  const int my_qp = sQpos[r];
  const bool row_ok = r < rows;

  // pass 1: the row's max and sum over its usable keys
  float m = kNegInf, l = 0.f;
  for (int t0 = 0; t0 < T; t0 += kTile) {
    const int keys = min(kTile, T - t0);
    __syncthreads();
    load_tile(sK, k + ((size_t)b * T + t0) * k_row + (size_t)hk * hd, keys,
              hd, k_row);
    if (t < kTile) sKpos[t] = t < keys ? kpos[(size_t)b * T + t0 + t] : -1;
    __syncthreads();
    if (t == 0) {
      kb = tile_bounds(sKpos, kTile, true);
      meet = tiles_meet(qb, kb, causal, window);
    }
    __syncthreads();
    if (!meet) continue;
    float sc[kTile / kLanes];
    float tmax = kNegInf;
#pragma unroll
    for (int j = 0; j < kTile / kLanes; ++j) {
      const int c = lane + kLanes * j;
      const bool ok = row_ok && usable(my_qp, sKpos[c], causal, window);
      sc[j] = ok ? scale * dot(sQ + r * qp_, sK + c * qp_, hd) : kNegInf;
      tmax = fmaxf(tmax, sc[j]);
    }
    tmax = lanes_max(tmax);
    const float m_new = fmaxf(m, tmax);
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < kTile / kLanes; ++j)
      psum += sc[j] > kNegInf ? expf(sc[j] - m_new) : 0.f;
    l = l * expf(m - m_new) + lanes_sum(psum);
    m = m_new;
  }
  const float lse = m + logf(fmaxf(l, FLT_MIN));

  // pass 2: dS = P * (d_out v^T - D) and dq += dS k
  float acc[kPerLane];
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) acc[i] = 0.f;
  for (int t0 = 0; t0 < T; t0 += kTile) {
    const int keys = min(kTile, T - t0);
    __syncthreads();
    load_tile(sK, k + ((size_t)b * T + t0) * k_row + (size_t)hk * hd, keys,
              hd, k_row);
    load_tile(sV, v + ((size_t)b * T + t0) * v_row + (size_t)hk * hdv, keys,
              hdv, v_row);
    if (t < kTile) sKpos[t] = t < keys ? kpos[(size_t)b * T + t0 + t] : -1;
    __syncthreads();
    if (t == 0) {
      kb = tile_bounds(sKpos, kTile, true);
      meet = tiles_meet(qb, kb, causal, window);
    }
    __syncthreads();
    if (!meet) continue;
#pragma unroll
    for (int j = 0; j < kTile / kLanes; ++j) {
      const int c = lane + kLanes * j;
      float ds = 0.f;
      if (row_ok && usable(my_qp, sKpos[c], causal, window)) {
        const float p =
            expf(scale * dot(sQ + r * qp_, sK + c * qp_, hd) - lse);
        const float dp = dot(sdO + r * vp_, sV + c * vp_, hdv);
        ds = p * (dp - D);
      }
      sdS[r * (kTile + 1) + c] = ds;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) {
      const int d = lane + kLanes * i;
      if (d < hd) {
        float a = acc[i];
        for (int c = 0; c < keys; ++c)
          a = fmaf(sdS[r * (kTile + 1) + c], sK[c * qp_ + d], a);
        acc[i] = a;
      }
    }
  }
  if (row_ok) {
    float* dst = dq + ((size_t)b * S + s0 + r) * q_row + (size_t)h * hd;
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) {
      const int d = lane + kLanes * i;
      if (d < hd) dst[d] = scale * acc[i];
    }
    if (lane == 0) {
      const size_t at = ((size_t)b * H + h) * S + s0 + r;
      lse_out[at] = lse;
      d_out_rows[at] = D;
    }
  }
}

// ---- kernel 2: dk and dv ---------------------------------------------------
__global__ void __launch_bounds__(kThreads)
attn_bwd_dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v,
                     const float* __restrict__ dout,
                     const int* __restrict__ qpos,
                     const int* __restrict__ kpos,
                     const float* __restrict__ lse_in,
                     const float* __restrict__ d_rows, float* __restrict__ dk,
                     float* __restrict__ dv, int S, int T, int H, int Hkv,
                     int hd, int hdv, float scale, int causal, int window) {
  extern __shared__ float smem[];
  const int qp_ = hd + 1, vp_ = hdv + 1;
  float* sK = smem;                          // [kTile][hd + 1]
  float* sV = sK + kTile * qp_;              // [kTile][hdv + 1]
  float* sQ = sV + kTile * vp_;              // [kTile][hd + 1]
  float* sdO = sQ + kTile * qp_;             // [kTile][hdv + 1]
  float* sP = sdO + kTile * vp_;             // [key][query] (kTile + 1)
  float* sdS = sP + kTile * (kTile + 1);     // [key][query] (kTile + 1)
  float* sLse = sdS + kTile * (kTile + 1);
  float* sD = sLse + kTile;
  int* sQpos = reinterpret_cast<int*>(sD + kTile);
  int* sKpos = sQpos + kTile;
  __shared__ Bounds qb, kb;
  __shared__ int meet;

  const int t0 = blockIdx.x * kTile, hk = blockIdx.y, b = blockIdx.z;
  const int group = H / Hkv;
  const int keys = min(kTile, T - t0);
  const int t = threadIdx.x, c = t / kLanes, lane = t % kLanes;

  const size_t q_row = (size_t)H * hd, o_row = (size_t)H * hdv;
  const size_t k_row = (size_t)Hkv * hd, v_row = (size_t)Hkv * hdv;
  load_tile(sK, k + ((size_t)b * T + t0) * k_row + (size_t)hk * hd, keys, hd,
            k_row);
  load_tile(sV, v + ((size_t)b * T + t0) * v_row + (size_t)hk * hdv, keys,
            hdv, v_row);
  if (t < kTile) sKpos[t] = t < keys ? kpos[(size_t)b * T + t0 + t] : -1;
  __syncthreads();
  if (t == 0) kb = tile_bounds(sKpos, kTile, true);
  const int my_kp = sKpos[c];

  float dk_acc[kPerLane], dv_acc[kPerLane];
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) dk_acc[i] = dv_acc[i] = 0.f;

  for (int g = 0; g < group; ++g) {
    const int h = hk * group + g;
    for (int s0 = 0; s0 < S; s0 += kTile) {
      const int rows = min(kTile, S - s0);
      __syncthreads();
      if (t < kTile) {
        const bool in = t < rows;
        const size_t at = ((size_t)b * H + h) * S + s0 + t;
        sQpos[t] = in ? qpos[(size_t)b * S + s0 + t] : INT_MIN;
        sLse[t] = in ? lse_in[at] : 0.f;
        sD[t] = in ? d_rows[at] : 0.f;
      }
      __syncthreads();
      if (t == 0) {
        qb = tile_bounds(sQpos, kTile, false);
        meet = tiles_meet(qb, kb, causal, window);
      }
      __syncthreads();
      if (!meet) continue;
      load_tile(sQ, q + ((size_t)b * S + s0) * q_row + (size_t)h * hd, rows,
                hd, q_row);
      load_tile(sdO, dout + ((size_t)b * S + s0) * o_row + (size_t)h * hdv,
                rows, hdv, o_row);
      __syncthreads();
#pragma unroll
      for (int j = 0; j < kTile / kLanes; ++j) {
        const int r = lane + kLanes * j;
        float p = 0.f, ds = 0.f;
        if (c < keys && r < rows &&
            usable(sQpos[r], my_kp, causal, window)) {
          p = expf(scale * dot(sQ + r * qp_, sK + c * qp_, hd) - sLse[r]);
          const float dp = dot(sdO + r * vp_, sV + c * vp_, hdv);
          ds = p * (dp - sD[r]);
        }
        sP[c * (kTile + 1) + r] = p;
        sdS[c * (kTile + 1) + r] = ds;
      }
      __syncthreads();
#pragma unroll
      for (int i = 0; i < kPerLane; ++i) {
        const int d = lane + kLanes * i;
        if (d < hdv) {
          float a = dv_acc[i];
          for (int r = 0; r < rows; ++r)
            a = fmaf(sP[c * (kTile + 1) + r], sdO[r * vp_ + d], a);
          dv_acc[i] = a;
        }
        if (d < hd) {
          float a = dk_acc[i];
          for (int r = 0; r < rows; ++r)
            a = fmaf(sdS[c * (kTile + 1) + r], sQ[r * qp_ + d], a);
          dk_acc[i] = a;
        }
      }
    }
  }
  if (c < keys) {
    float* dkr = dk + ((size_t)b * T + t0 + c) * k_row + (size_t)hk * hd;
    float* dvr = dv + ((size_t)b * T + t0 + c) * v_row + (size_t)hk * hdv;
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) {
      const int d = lane + kLanes * i;
      if (d < hd) dkr[d] = scale * dk_acc[i];
      if (d < hdv) dvr[d] = dv_acc[i];
    }
  }
}

size_t dq_smem(int hd, int hdv) {
  return sizeof(float) * (2 * kTile * (hd + 1) + 2 * kTile * (hdv + 1) +
                          kTile * (kTile + 1)) +
         sizeof(int) * 2 * kTile;
}

size_t dkdv_smem(int hd, int hdv) {
  return sizeof(float) * (2 * kTile * (hd + 1) + 2 * kTile * (hdv + 1) +
                          2 * kTile * (kTile + 1) + 2 * kTile) +
         sizeof(int) * 2 * kTile;
}


int launch(const float* q, const float* k, const float* v, const float* out,
           const float* dout, const int* qpos, const int* kpos, float* dq,
           float* dk, float* dv, float* lse, float* drows, int B, int S,
           int T, int H, int Hkv, int hd, int hdv, float scale, int causal,
           int window, cudaStream_t st) {
  const size_t s1 = dq_smem(hd, hdv), s2 = dkdv_smem(hd, hdv);
  cudaFuncSetAttribute(attn_bwd_dq_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)s1);
  cudaFuncSetAttribute(attn_bwd_dkdv_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)s2);
  REPRO_LAUNCH_CHECK();
  dim3 g1((S + kTile - 1) / kTile, H, B);
  attn_bwd_dq_kernel<<<g1, kThreads, s1, st>>>(q, k, v, out, dout, qpos,
                                                kpos, dq, lse, drows, S, T, H,
                                                Hkv, hd, hdv, scale, causal,
                                                window);
  REPRO_LAUNCH_CHECK();
  dim3 g2((T + kTile - 1) / kTile, Hkv, B);
  attn_bwd_dkdv_kernel<<<g2, kThreads, s2, st>>>(q, k, v, dout, qpos, kpos,
                                                  lse, drows, dk, dv, S, T, H,
                                                  Hkv, hd, hdv, scale, causal,
                                                  window);
  REPRO_LAUNCH_CHECK();
  return 0;
}

}  // namespace simt

// ---------------------------------------------------------------------------
// Tensor-core route
// ---------------------------------------------------------------------------
namespace tc {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 16 * kWarps;  // query rows (dq) or keys (dk/dv) a block
constexpr int kStep = 32;           // keys (dq) or query rows (dk/dv) a stage
constexpr int kMaxDim = 128;
constexpr float kLog2e = 1.4426950408889634f;
constexpr unsigned kFull = 0xffffffffu;

using tcore::mma_tf32;
using tcore::split;

// The 3xTF32 products of an m16 row tile against N n8 column tiles,
// c[n] += a b[n]: the three passes (lo hi, hi lo, hi hi: small terms first,
// as tcore::mma_3xtf32 adds them) each run over all N accumulators before
// the next, so N independent mma.sync are in flight instead of one chain
// of three (the mma asm is volatile: sent in program order).  Each
// accumulator sees the same three adds in the same order as
// mma_3xtf32 would give it.
template <int N>
__device__ __forceinline__ void mma3_row(float (*c)[4], const uint32_t* ah,
                                         const uint32_t* al,
                                         uint32_t (*bh)[2],
                                         uint32_t (*bl)[2]) {
#pragma unroll
  for (int n = 0; n < N; ++n) mma_tf32(c[n], al, bh[n][0], bh[n][1]);
#pragma unroll
  for (int n = 0; n < N; ++n) mma_tf32(c[n], ah, bl[n][0], bl[n][1]);
#pragma unroll
  for (int n = 0; n < N; ++n) mma_tf32(c[n], ah, bh[n][0], bh[n][1]);
}

// D: hd and hdv padded up to 32, 64 or 128 (the padding is zero-filled).
// Rows are LD = D + 4 floats apart (LD = 4 mod 32): lane (g, t) reading
// (row g, column t) hits bank 4 g + t, reading (row 2 t, column g) bank
// 8 t + g, 32 distinct banks either way.
template <int D>
struct Layout {
  static constexpr int LD = D + 4;
  static constexpr int kOwn = kRows * LD;        // the block's own rows
  static constexpr int kStage = 2 * kStep * LD;  // two operands of a tile
  // two own operands, two rounds of WK tiles, and per tile kStep words of
  // positions (dq) or positions, lse and D (dk/dv)
  static constexpr size_t smem(int wk) {
    return (2 * (size_t)kOwn + 2 * (size_t)wk * (kStage + 3 * kStep)) *
           sizeof(float);
  }
};

// Starts the copies of rows [0, R) of a (rows, width) block whose row r
// begins at src + r * stride, into dst (row pitch LD); rows past `valid`
// and columns past `width` (up to D) are zeros.
template <int R, int D>
__device__ __forceinline__ void stage_rows(float* dst, const float* src,
                                           size_t stride, int valid,
                                           int width) {
  constexpr int kPieces = D / 4;
  for (int i = threadIdx.x; i < R * kPieces; i += blockDim.x) {
    const int r = i / kPieces, c = (i % kPieces) * 4;
    const bool fill = r < valid && c < width;
    tcore::cp_async16(dst + r * Layout<D>::LD + c,
                      fill ? src + r * stride + c : src, fill);
  }
}

// kStep 4-byte words from src (positions, lse or D), zeros past `valid`
__device__ __forceinline__ void stage_words(void* dst, const void* src,
                                            int valid) {
  if (threadIdx.x < kStep) {
    const bool in = (int)threadIdx.x < valid;
    tcore::cp_async4(static_cast<int*>(dst) + threadIdx.x,
                     static_cast<const int*>(src) + (in ? threadIdx.x : 0),
                     in);
  }
}

__device__ __forceinline__ bool usable(int qp, int kp, int causal,
                                       int window) {
  return kp >= 0 && (!causal || kp <= qp) && (window <= 0 || qp - kp < window);
}

// Whether every query with a position in [qmin, qmax] may use every key
// with a position in [kmin, kmax] (all of them present): the tile needs
// no mask.
__device__ __forceinline__ bool whole(int qmin, int qmax, int kmin, int kmax,
                                      int causal, int window) {
  return kmin >= 0 && (!causal || kmax <= qmin) &&
         (window <= 0 || qmax - kmin < window);
}

// 2^x on the special-function unit (flushes denormals), as the forward
// kernel's softmax
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The first key tile at or after j (of kStep keys) that some query with a
// position in [qmin, qmax] may use, or ntiles: one key a lane, every warp
// alike, no barrier.
__device__ __forceinline__ int next_key_tile(const int* __restrict__ kp_b,
                                             int T, int j, int ntiles,
                                             int causal, int window, int qmin,
                                             int qmax) {
  const int lane = threadIdx.x & 31;
  for (; j < ntiles; ++j) {
    const int key = j * kStep + lane;
    const int kp = key < T ? __ldg(kp_b + key) : -1;
    const bool ok = kp >= 0 && (!causal || kp <= qmax) &&
                    (window <= 0 || qmin - kp < window);
    if (__any_sync(kFull, ok)) return j;
  }
  return ntiles;
}

// The first query tile at or after j (of kStep rows) some of whose queries
// may use a key with a position in [kmin, kmax], or ntiles.
__device__ __forceinline__ int next_query_tile(const int* __restrict__ qp_b,
                                               int S, int j, int ntiles,
                                               int causal, int window,
                                               int kmin, int kmax) {
  const int lane = threadIdx.x & 31;
  for (; j < ntiles; ++j) {
    const int row = j * kStep + lane;
    const int qp = row < S ? __ldg(qp_b + row) : 0;
    const bool ok = row < S && (!causal || kmin <= qp) &&
                    (window <= 0 || qp - kmax < window);
    if (__any_sync(kFull, ok)) return j;
  }
  return ntiles;
}

// The split A fragment of the warp's 16 staged rows a (pitch LD) at the
// columns kc * 8 ..: (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4).
template <int D>
__device__ __forceinline__ void frag_a(const float* a, int kc, uint32_t* ah,
                                       uint32_t* al) {
  constexpr int LD = Layout<D>::LD;
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  const float* ar = a + g * LD + kc * 8 + t;
  split(ar[0], ah[0], al[0]);
  split(ar[8 * LD], ah[1], al[1]);
  split(ar[4], ah[2], al[2]);
  split(ar[8 * LD + 4], ah[3], al[3]);
}

// The split B fragments of B = (staged rows b)^T at k = kc * 8 .. for the
// kStep / 8 n8 tiles of rows: B[k][n] = b[n][k].
template <int D>
__device__ __forceinline__ void frag_bt(const float* b, int kc,
                                        uint32_t (*bh)[2],
                                        uint32_t (*bl)[2]) {
  constexpr int LD = Layout<D>::LD;
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
#pragma unroll
  for (int n = 0; n < kStep / 8; ++n) {
    const float* br = b + (n * 8 + g) * LD + kc * 8 + t;
    split(br[0], bh[n][0], bl[n][0]);
    split(br[4], bh[n][1], bl[n][1]);
  }
}

// The split B fragments of the staged rows b at k-step kk (k-index t: row
// 2t, t + 4: row 2t + 1, the score fragments' order) for N n8 column
// tiles from n0.
template <int D, int N>
__device__ __forceinline__ void frag_b(const float* b, int kk, int n0,
                                       uint32_t (*bh)[2], uint32_t (*bl)[2]) {
  constexpr int LD = Layout<D>::LD;
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
#pragma unroll
  for (int n = 0; n < N; ++n) {
    const float* br = b + (kk * 8 + 2 * t) * LD + (n0 + n) * 8 + g;
    split(br[0], bh[n][0], bl[n][0]);
    split(br[LD], bh[n][1], bl[n][1]);
  }
}

// The A fragments of a 16 x kStep tile held as m16n8 score fragments
// (x[n][0..3]: (g, 2t), (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1) of n8
// tile n), split, in the k order frag_b reads.
__device__ __forceinline__ void score_frags(float (*x)[4], uint32_t (*ah)[4],
                                            uint32_t (*al)[4]) {
#pragma unroll
  for (int kk = 0; kk < kStep / 8; ++kk) {
    split(x[kk][0], ah[kk][0], al[kk][0]);
    split(x[kk][2], ah[kk][1], al[kk][1]);
    split(x[kk][1], ah[kk][2], al[kk][2]);
    split(x[kk][3], ah[kk][3], al[kk][3]);
  }
}

// acc (16 x D of the warp: n8 tiles over the columns) += A B, A the
// warp's 16 x kStep tile given as split fragments (score_frags), B the
// staged (kStep x LD) rows b; each n8 tile's product summed in the mma
// over the kStep rows, then added in fp32.  Four n8 tiles a pass (eight
// raised the registers past three blocks an SM and ran slower).
template <int D>
__device__ __forceinline__ void add_product(float (*acc)[4],
                                            uint32_t (*ah)[4],
                                            uint32_t (*al)[4],
                                            const float* b, int width) {
  constexpr int kGroup = 4;
#pragma unroll
  for (int n0 = 0; n0 < D / 8; n0 += kGroup) {
    if (n0 * 8 >= width) break;
    float part[kGroup][4] = {};
#pragma unroll
    for (int kk = 0; kk < kStep / 8; ++kk) {
      uint32_t bh[kGroup][2], bl[kGroup][2];
      frag_b<D, kGroup>(b, kk, n0, bh, bl);
      mma3_row<kGroup>(part, ah[kk], al[kk], bh, bl);
    }
#pragma unroll
    for (int n = 0; n < kGroup; ++n)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[n0 + n][q] += part[n][q];
  }
}

// s[n] (16 x kStep) = A B^T over `width` columns: A the warp's 16 staged
// rows a (pitch LD), B the kStep staged rows b (pitch LD).
template <int D>
__device__ __forceinline__ void scores(float (*s)[4], const float* a,
                                       const float* b, int width) {
  constexpr int N = kStep / 8;
#pragma unroll
  for (int n = 0; n < N; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
  for (int kc = 0; kc < D / 8; ++kc) {
    if (kc * 8 >= width) break;
    uint32_t ah[4], al[4], bh[N][2], bl[N][2];
    frag_a<D>(a, kc, ah, al);
    frag_bt<D>(b, kc, bh, bl);
    mma3_row<N>(s, ah, al, bh, bl);
  }
}

// Partial sums of the key groups (WK = 2): after the tile loop, the warps
// of group 1 leave their accumulators in shared memory (the stages are
// free then), one float a thread and slot, and the warp of group 0 that
// owns the same rows adds them to its own, group 0's first: one fixed
// order.  N floats a thread.
template <int N>
__device__ __forceinline__ void merge_groups(float* sm, float* acc, int wk,
                                             int wr) {
  const int lane = threadIdx.x & 31;
  __syncthreads();
  if (wk == 1) {
    float* dst = sm + wr * N * 32;
#pragma unroll
    for (int i = 0; i < N; ++i) dst[i * 32 + lane] = acc[i];
  }
  __syncthreads();
  if (wk == 0) {
    const float* src = sm + wr * N * 32;
#pragma unroll
    for (int i = 0; i < N; ++i) acc[i] += src[i * 32 + lane];
  }
}

// ---- kernel 1: dq, and D of the rows -------------------------------------
// 4 WK warps: warp w takes rows 16 (w % 4) .. and every WK-th used key
// tile from w / 4 on (WK = 2 where the keys are many: the longest rows'
// chain of tiles halves).
template <int D, int WK>
__global__ void __launch_bounds__(kThreads * WK)
tc_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, const float* __restrict__ out,
             const float* __restrict__ dout, const int* __restrict__ qpos,
             const int* __restrict__ kpos, const float* __restrict__ lse,
             float* __restrict__ dq, float* __restrict__ drows, int S, int T,
             int H, int Hkv, int hd, int hdv, float scale, int causal,
             int window) {
  using L = Layout<D>;
  constexpr int LD = L::LD;
  extern __shared__ __align__(16) float sm[];
  float* sQ = sm;
  float* sO = sQ + L::kOwn;
  float* stages = sO + L::kOwn;  // per tile: K rows, then V rows
  int* sKp = reinterpret_cast<int*>(stages + 2 * WK * L::kStage);

  const int b = blockIdx.z, h = blockIdx.y, hk = h / (H / Hkv);
  // the last query rows first: under a causal mask they have the most keys
  const int s0 = (gridDim.x - 1 - blockIdx.x) * kRows;
  const int rows = min(kRows, S - s0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wr = warp % kWarps, wk = warp / kWarps;
  const int g = lane >> 2, t = lane & 3;
  const size_t q_row = (size_t)H * hd, o_row = (size_t)H * hdv;
  const size_t k_row = (size_t)Hkv * hd, v_row = (size_t)Hkv * hdv;
  const int* qp_b = qpos + (size_t)b * S;
  const int* kp_b = kpos + (size_t)b * T;

  stage_rows<kRows, D>(sQ, q + ((size_t)b * S + s0) * q_row + (size_t)h * hd,
                       q_row, rows, hd);
  stage_rows<kRows, D>(sO,
                       dout + ((size_t)b * S + s0) * o_row + (size_t)h * hdv,
                       o_row, rows, hdv);
  tcore::cp_async_commit();

  // the block's query positions, for the tile skip
  int qmin = INT_MAX, qmax = INT_MIN;
  for (int r = lane; r < rows; r += 32) {
    qmin = min(qmin, qp_b[s0 + r]);
    qmax = max(qmax, qp_b[s0 + r]);
  }
  qmin = __reduce_min_sync(kFull, qmin);
  qmax = __reduce_max_sync(kFull, qmax);

  // D = rowsum(d_out * out) of the warp's 16 rows: lanes 2j and 2j + 1
  // take the two halves of row j with float4 loads all in flight (hdv is
  // a multiple of 16), one shuffle adds them (both lanes the same bits);
  // then each lane fetches its rows g and g + 8; group 0 writes all 16
  // for kernel 2
  const size_t hrow = ((size_t)b * H + h) * S;
  float dsum = 0.f;
  {
    const int r = s0 + wr * 16 + (lane >> 1), half = hdv / 2;
    if (r < S) {
      const size_t at = ((size_t)b * S + r) * o_row + (size_t)h * hdv +
                        (lane & 1) * half;
      const float4* o = reinterpret_cast<const float4*>(out + at);
      const float4* d = reinterpret_cast<const float4*>(dout + at);
#pragma unroll 4
      for (int c = 0; c < half / 4; ++c) {
        const float4 x = __ldg(o + c), y = __ldg(d + c);
        dsum = fmaf(y.x, x.x, dsum);
        dsum = fmaf(y.y, x.y, dsum);
        dsum = fmaf(y.z, x.z, dsum);
        dsum = fmaf(y.w, x.w, dsum);
      }
    }
    dsum += __shfl_xor_sync(kFull, dsum, 1);
    if (wk == 0 && !(lane & 1) && r < S) drows[hrow + r] = dsum;
  }
  const float dv0 = __shfl_sync(kFull, dsum, 2 * g);
  const float dv1 = __shfl_sync(kFull, dsum, 2 * g + 16);
  const int r0 = s0 + wr * 16 + g, r1 = r0 + 8;
  const bool in0 = r0 < S, in1 = r1 < S;
  const int qp0 = in0 ? qp_b[r0] : 0, qp1 = in1 ? qp_b[r1] : 0;
  const float l0 = in0 ? lse[hrow + r0] * kLog2e : 0.f;
  const float l1 = in1 ? lse[hrow + r1] * kLog2e : 0.f;
  const float qs = scale * kLog2e;
  // the warp's 16 rows: all present, and their position range
  const bool rows_in = s0 + wr * 16 + 16 <= S;
  const int wq_min = __reduce_min_sync(kFull, min(qp0, qp1));
  const int wq_max = __reduce_max_sync(kFull, max(qp0, qp1));

  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  const int ntiles = (T + kStep - 1) / kStep;
  // a round stages the next WK used tiles (one per key group) into buffer
  // set `set` while the round before computes; `mine`: this warp's tile
  int cursor = -1;  // the last tile handed out
  auto fill = [&](int set, int& mine) {
    int count = 0;
    mine = ntiles;
    for (int gi = 0; gi < WK; ++gi) {
      const int j = next_key_tile(kp_b, T, cursor + 1, ntiles, causal,
                                  window, qmin, qmax);
      if (j >= ntiles) {
        cursor = ntiles;
        break;
      }
      cursor = j;
      const int buf = set * WK + gi, t0 = j * kStep;
      const int keys = min(kStep, T - t0);
      float* st = stages + buf * L::kStage;
      stage_rows<kStep, D>(st,
                           k + ((size_t)b * T + t0) * k_row + (size_t)hk * hd,
                           k_row, keys, hd);
      stage_rows<kStep, D>(st + kStep * LD,
                           v + ((size_t)b * T + t0) * v_row +
                               (size_t)hk * hdv,
                           v_row, keys, hdv);
      stage_words(sKp + buf * kStep, kp_b + t0, keys);
      if (gi == wk) mine = j;
      ++count;
    }
    return count;
  };
  int set = 0, mine;
  int count = fill(0, mine);
  tcore::cp_async_commit();
  while (count > 0) {
    int mine_next;
    const int count_next = fill(set ^ 1, mine_next);
    tcore::cp_async_commit();
    tcore::cp_async_wait<1>();
    __syncthreads();
    if (mine < ntiles) {
      const int buf = set * WK + wk;
      const float* sK = stages + buf * L::kStage;
      const float* sV = sK + kStep * LD;
      const int* kp = sKp + buf * kStep;
      const int t0 = mine * kStep;
      float sc[kStep / 8][4], ds[kStep / 8][4];
      scores<D>(sc, sQ + wr * 16 * LD, sK, hd);     // q k^T
      scores<D>(ds, sO + wr * 16 * LD, sV, hdv);    // d_out v^T
      // P and dS = P (dP - D) on the fragments: (g, 2t), (g, 2t + 1),
      // (g + 8, 2t), (g + 8, 2t + 1) of each n8 key tile; the mask only
      // where some (row, key) of the warp's tile is not usable
      const int kpl = kp[lane];   // one key a lane (kStep == 32)
      const bool all = rows_in && __all_sync(kFull, t0 + lane < T) &&
                       whole(wq_min, wq_max, __reduce_min_sync(kFull, kpl),
                             __reduce_max_sync(kFull, kpl), causal, window);
#pragma unroll
      for (int n = 0; n < kStep / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = n * 8 + 2 * t + (e & 1);
          const bool hi = e >= 2;
          const bool ok = all || ((hi ? in1 : in0) && t0 + c < T &&
                                  usable(hi ? qp1 : qp0, kp[c], causal,
                                         window));
          const float p =
              ok ? fast_exp2(sc[n][e] * qs - (hi ? l1 : l0)) : 0.f;
          ds[n][e] = ok ? p * (ds[n][e] - (hi ? dv1 : dv0)) : 0.f;
        }
      uint32_t ah[kStep / 8][4], al[kStep / 8][4];
      score_frags(ds, ah, al);
      add_product<D>(acc, ah, al, sK, hd);          // dq += dS k
    }
    __syncthreads();  // every warp is done with this round's tiles
    mine = mine_next;
    count = count_next;
    set ^= 1;
  }
  tcore::cp_async_wait<0>();
  if (WK > 1) {
    merge_groups<D / 2>(stages, &acc[0][0], wk, wr);
    if (wk > 0) return;
  }

#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int col = n * 8 + 2 * t;
    if (col >= hd) break;
    if (in0)
      *reinterpret_cast<float2*>(dq + ((size_t)b * S + r0) * q_row +
                                 (size_t)h * hd + col) =
          make_float2(scale * acc[n][0], scale * acc[n][1]);
    if (in1)
      *reinterpret_cast<float2*>(dq + ((size_t)b * S + r1) * q_row +
                                 (size_t)h * hd + col) =
          make_float2(scale * acc[n][2], scale * acc[n][3]);
  }
}

// ---- kernel 2: dk and dv of one query head --------------------------------
// 4 WK warps: warp w takes keys 16 (w % 4) .. and every WK-th used query
// tile from w / 4 on.  dk_part null (H == Hkv): dk = scale dS^T q and dv go
// straight to dk, dv; else the head's unscaled terms go to dk_part /
// dv_part (B, T, H, hd / hdv), which kernel 3 sums over each group.
template <int D, int WK>
__global__ void __launch_bounds__(kThreads * WK)
tc_dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, const float* __restrict__ dout,
               const int* __restrict__ qpos, const int* __restrict__ kpos,
               const float* __restrict__ lse, const float* __restrict__ drows,
               float* __restrict__ dk, float* __restrict__ dv,
               float* __restrict__ dk_part, float* __restrict__ dv_part,
               int S, int T, int H, int Hkv, int hd, int hdv, float scale,
               int causal, int window) {
  using L = Layout<D>;
  constexpr int LD = L::LD;
  extern __shared__ __align__(16) float sm[];
  float* sK = sm;
  float* sV = sK + L::kOwn;
  float* stages = sV + L::kOwn;  // per tile: q rows, then d_out rows
  int* sQp = reinterpret_cast<int*>(stages + 2 * WK * L::kStage);
  float* sL = reinterpret_cast<float*>(sQp + 2 * WK * kStep);
  float* sD = sL + 2 * WK * kStep;

  const int b = blockIdx.z, h = blockIdx.y, hk = h / (H / Hkv);
  const int t0 = blockIdx.x * kRows;
  const int keys = min(kRows, T - t0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wr = warp % kWarps, wk = warp / kWarps;
  const int g = lane >> 2, t = lane & 3;
  const size_t q_row = (size_t)H * hd, o_row = (size_t)H * hdv;
  const size_t k_row = (size_t)Hkv * hd, v_row = (size_t)Hkv * hdv;
  const int* qp_b = qpos + (size_t)b * S;
  const int* kp_b = kpos + (size_t)b * T;

  stage_rows<kRows, D>(sK, k + ((size_t)b * T + t0) * k_row + (size_t)hk * hd,
                       k_row, keys, hd);
  stage_rows<kRows, D>(sV,
                       v + ((size_t)b * T + t0) * v_row + (size_t)hk * hdv,
                       v_row, keys, hdv);
  tcore::cp_async_commit();

  // the block's usable key positions, for the tile skip
  int kmin = INT_MAX, kmax = INT_MIN;
  for (int c = lane; c < keys; c += 32) {
    const int kp = kp_b[t0 + c];
    if (kp >= 0) {
      kmin = min(kmin, kp);
      kmax = max(kmax, kp);
    }
  }
  kmin = __reduce_min_sync(kFull, kmin);
  kmax = __reduce_max_sync(kFull, kmax);
  const bool any_key = kmax >= kmin;

  const int c0 = t0 + wr * 16 + g, c1 = c0 + 8;
  const int kp0 = c0 < T ? kp_b[c0] : -1, kp1 = c1 < T ? kp_b[c1] : -1;
  const float qs = scale * kLog2e;
  // the warp's 16 keys, their position range (-1 if one is missing)
  const int wk_min = __reduce_min_sync(kFull, min(kp0, kp1));
  const int wk_max = __reduce_max_sync(kFull, max(kp0, kp1));

  float acc[2][D / 8][4];   // dk, then dv
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[0][n][e] = acc[1][n][e] = 0.f;

  const int ntiles = (S + kStep - 1) / kStep;
  int cursor = any_key ? -1 : ntiles;  // the last tile handed out
  auto fill = [&](int set, int& mine) {
    int count = 0;
    mine = ntiles;
    for (int gi = 0; gi < WK; ++gi) {
      const int j = cursor + 1 < ntiles
                        ? next_query_tile(qp_b, S, cursor + 1, ntiles,
                                          causal, window, kmin, kmax)
                        : ntiles;
      if (j >= ntiles) {
        cursor = ntiles;
        break;
      }
      cursor = j;
      const int buf = set * WK + gi, s0 = j * kStep;
      const int rows = min(kStep, S - s0);
      float* st = stages + buf * L::kStage;
      stage_rows<kStep, D>(st,
                           q + ((size_t)b * S + s0) * q_row + (size_t)h * hd,
                           q_row, rows, hd);
      stage_rows<kStep, D>(st + kStep * LD,
                           dout + ((size_t)b * S + s0) * o_row +
                               (size_t)h * hdv,
                           o_row, rows, hdv);
      const size_t at = ((size_t)b * H + h) * S + s0;
      stage_words(sQp + buf * kStep, qp_b + s0, rows);
      stage_words(sL + buf * kStep, lse + at, rows);
      stage_words(sD + buf * kStep, drows + at, rows);
      if (gi == wk) mine = j;
      ++count;
    }
    return count;
  };
  int set = 0, mine;
  int count = fill(0, mine);
  tcore::cp_async_commit();
  while (count > 0) {
    int mine_next;
    const int count_next = fill(set ^ 1, mine_next);
    tcore::cp_async_commit();
    tcore::cp_async_wait<1>();
    __syncthreads();
    if (mine < ntiles) {
      const int buf = set * WK + wk;
      const float* sQ = stages + buf * L::kStage;
      const float* sO = sQ + kStep * LD;
      const int* qp = sQp + buf * kStep;
      const float* lq = sL + buf * kStep;
      const float* drow = sD + buf * kStep;
      const int s0 = mine * kStep;
      float pt[kStep / 8][4], ds[kStep / 8][4];
      scores<D>(pt, sK + wr * 16 * LD, sQ, hd);     // k q^T
      scores<D>(ds, sV + wr * 16 * LD, sO, hdv);    // v d_out^T
      // P^T and dS^T on the fragments: keys g, g + 8 and queries 2t,
      // 2t + 1; the mask only where some (key, query) of the warp's tile
      // is not usable
      const int qpl = qp[lane];   // one query a lane (kStep == 32)
      const bool all = __all_sync(kFull, s0 + lane < S) &&
                       whole(__reduce_min_sync(kFull, qpl),
                             __reduce_max_sync(kFull, qpl), wk_min, wk_max,
                             causal, window);
#pragma unroll
      for (int n = 0; n < kStep / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = n * 8 + 2 * t + (e & 1);
          const bool ok = all || (s0 + c < S &&
                                  usable(qp[c], e >= 2 ? kp1 : kp0, causal,
                                         window));
          const float p =
              ok ? fast_exp2(pt[n][e] * qs - lq[c] * kLog2e) : 0.f;
          pt[n][e] = p;
          ds[n][e] = ok ? p * (ds[n][e] - drow[c]) : 0.f;
        }
      uint32_t ah[kStep / 8][4], al[kStep / 8][4];
      score_frags(pt, ah, al);
      add_product<D>(acc[1], ah, al, sO, hdv);      // dv += P^T d_out
      score_frags(ds, ah, al);
      add_product<D>(acc[0], ah, al, sQ, hd);       // dk += dS^T q
    }
    __syncthreads();  // every warp is done with this round's tiles
    mine = mine_next;
    count = count_next;
    set ^= 1;
  }
  tcore::cp_async_wait<0>();
  if (WK > 1) {
    merge_groups<D>(stages, &acc[0][0][0], wk, wr);
    if (wk > 0) return;
  }

  // this head's rows of dk, dv (or of their partials)
  const bool part = dk_part != nullptr;
  const float ks = part ? 1.f : scale;
  float* kdst = part ? dk_part : dk;
  float* vdst = part ? dv_part : dv;
  const int kh = part ? h : hk, nh = part ? H : Hkv;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int col = n * 8 + 2 * t;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int c = half ? c1 : c0;
      if (c >= T) continue;
      const size_t row = (size_t)b * T + c;
      if (col < hd)
        *reinterpret_cast<float2*>(kdst + (row * nh + kh) * hd + col) =
            make_float2(ks * acc[0][n][2 * half],
                        ks * acc[0][n][2 * half + 1]);
      if (col < hdv)
        *reinterpret_cast<float2*>(vdst + (row * nh + kh) * hdv + col) =
            make_float2(acc[1][n][2 * half], acc[1][n][2 * half + 1]);
    }
  }
}

// ---- kernel 3 (GQA): dk, dv summed over each group's heads ----------------
// dk = scale (sum over g of dk_part[:, :, hk G + g]) and dv likewise, the
// heads added in order; one float4 a thread.  rows = B T.
constexpr int kSumThreads = 256;

__global__ void __launch_bounds__(kSumThreads)
tc_group_sum_kernel(const float* __restrict__ dk_part,
                    const float* __restrict__ dv_part, float* __restrict__ dk,
                    float* __restrict__ dv, int rows, int H, int Hkv, int hd,
                    int hdv, float scale) {
  const int group = H / Hkv;
  const size_t nk = (size_t)rows * Hkv * (hd / 4);
  const size_t nv = (size_t)rows * Hkv * (hdv / 4);
  for (size_t i = (size_t)blockIdx.x * kSumThreads + threadIdx.x; i < nk + nv;
       i += (size_t)gridDim.x * kSumThreads) {
    const bool is_v = i >= nk;
    const size_t o = is_v ? i - nk : i;   // (row, hk, c4) of the output
    const int w4 = (is_v ? hdv : hd) / 4;
    const size_t rk = o / w4;             // row Hkv + hk
    const float4* src = reinterpret_cast<const float4*>(is_v ? dv_part
                                                             : dk_part) +
                        ((rk / Hkv) * H + (rk % Hkv) * group) * w4 + o % w4;
    float4 acc = src[0];
    for (int gi = 1; gi < group; ++gi) {
      const float4 x = src[(size_t)gi * w4];
      acc.x += x.x;
      acc.y += x.y;
      acc.z += x.z;
      acc.w += x.w;
    }
    if (!is_v) {
      acc.x *= scale;
      acc.y *= scale;
      acc.z *= scale;
      acc.w *= scale;
    }
    reinterpret_cast<float4*>(is_v ? dv : dk)[o] = acc;
  }
}

inline bool aligned16(std::initializer_list<const void*> ptrs) {
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return false;
  return true;
}

// The route takes the shape: head dims multiples of 16 up to 128 and
// 16-byte aligned operands (cp.async and float2 stores).
inline bool takes(const void* q, const void* k, const void* v,
                  const void* out, const void* dout, int hd, int hdv) {
  return hd % 16 == 0 && hdv % 16 == 0 && hd <= kMaxDim && hdv <= kMaxDim &&
         aligned16({q, k, v, out, dout});
}

// The kernels of one D and WK, their shared-memory limit set once.
template <int D, int WK>
int launch_dw(const float* q, const float* k, const float* v,
              const float* out, const float* dout, const int* qpos,
              const int* kpos, float* dq, float* dk, float* dv,
              const float* lse, float* drows, float* dk_part,
              float* dv_part, int B, int S, int T, int H, int Hkv, int hd,
              int hdv, float scale, int causal, int window, cudaStream_t st) {
  constexpr size_t kSmem = Layout<D>::smem(WK);
  static bool smem_set = false;
  if (!smem_set) {
    cudaError_t err = cudaFuncSetAttribute(
        tc_dq_kernel<D, WK>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)kSmem);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(tc_dkdv_kernel<D, WK>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)kSmem);
    if (err != cudaSuccess) return (int)err;
    smem_set = true;
  }
  tc_dq_kernel<D, WK><<<dim3((S + kRows - 1) / kRows, H, B), kThreads * WK,
                        kSmem, st>>>(q, k, v, out, dout, qpos, kpos, lse, dq,
                                     drows, S, T, H, Hkv, hd, hdv, scale,
                                     causal, window);
  REPRO_LAUNCH_CHECK();
  const bool grouped = H != Hkv;
  tc_dkdv_kernel<D, WK><<<dim3((T + kRows - 1) / kRows, H, B), kThreads * WK,
                          kSmem, st>>>(
      q, k, v, dout, qpos, kpos, lse, drows, dk, dv,
      grouped ? dk_part : nullptr, grouped ? dv_part : nullptr, S, T, H, Hkv,
      hd, hdv, scale, causal, window);
  REPRO_LAUNCH_CHECK();
  if (grouped) {
    const size_t n4 = (size_t)B * T * Hkv * (hd + hdv) / 4;
    const unsigned blocks = (unsigned)std::min<size_t>(
        (n4 + kSumThreads - 1) / kSumThreads, 132 * 8);
    tc_group_sum_kernel<<<blocks, kSumThreads, 0, st>>>(
        dk_part, dv_part, dk, dv, B * T, H, Hkv, hd, hdv, scale);
    REPRO_LAUNCH_CHECK();
  }
  return 0;
}

// Two key groups (WK = 2) once a block's rows see more than kSplitTiles
// tiles of the other operand: the longest chain of tiles a warp walks
// halves, and the card holds twice the warps.
constexpr int kSplitTiles = 4;

template <int D>
int launch_d(const float* q, const float* k, const float* v,
             const float* out, const float* dout, const int* qpos,
             const int* kpos, float* dq, float* dk, float* dv,
             const float* lse, float* drows, float* dk_part, float* dv_part,
             int B, int S, int T, int H, int Hkv, int hd, int hdv,
             float scale, int causal, int window, cudaStream_t st) {
  const bool split = std::max(S, T) > kSplitTiles * kStep;
  return (split ? launch_dw<D, 2> : launch_dw<D, 1>)(
      q, k, v, out, dout, qpos, kpos, dq, dk, dv, lse, drows, dk_part,
      dv_part, B, S, T, H, Hkv, hd, hdv, scale, causal, window, st);
}

int launch(const float* q, const float* k, const float* v, const float* out,
           const float* dout, const int* qpos, const int* kpos, float* dq,
           float* dk, float* dv, const float* lse, float* drows,
           float* dk_part, float* dv_part, int B, int S, int T, int H,
           int Hkv, int hd, int hdv, float scale, int causal, int window,
           cudaStream_t st) {
  const int d = max(hd, hdv);
  auto go = [&](auto fn) {
    return fn(q, k, v, out, dout, qpos, kpos, dq, dk, dv, lse, drows,
              dk_part, dv_part, B, S, T, H, Hkv, hd, hdv, scale, causal,
              window, st);
  };
  if (d <= 32) return go(launch_d<32>);
  if (d <= 64) return go(launch_d<64>);
  return go(launch_d<128>);
}

}  // namespace tc

}  // namespace attn_bwd

// 1 if a call with these operands takes the tensor-core route, else 0 (the
// SIMT route): the wrapper hands the forward's lse to the first only, and
// tests and the smoke run check both.  The outputs come from the caching
// allocator, whose blocks are 512-byte aligned.
REPRO_API int repro_flash_attention_bwd_route(const void* q, const void* k,
                                              const void* v, const void* out,
                                              const void* dout, int hd,
                                              int hdv) {
  return attn_bwd::tc::takes(q, k, v, out, dout, hd, hdv) ? 1 : 0;
}

// All operands contiguous fp32: q (B, S, H, hd), k (B, T, Hkv, hd), v
// (B, T, Hkv, hdv), out and d_out (B, S, H, hdv); positions (B, S) and
// (B, T) int32; outputs dq, dk, dv like q, k, v; lse (B, H, S) fp32: the
// forward's rows' log-sum-exp, read by the tensor-core route, scratch the
// SIMT route writes; drows (B, H, S) fp32 scratch; dk_part, dv_part
// (B, T, H, hd / hdv) fp32 scratch of the tensor-core route when H != Hkv
// (else null).  H % Hkv == 0, hd and hdv <= 128, B and H <= 65535,
// S, T >= 1.  window <= 0: no window.  Launches on `stream`: the SIMT
// route 2, the tensor-core route 2, and 3 when H != Hkv.
REPRO_API int repro_flash_attention_bwd(
    const float* q, const float* k, const float* v, const float* out,
    const float* dout, const int* qpos, const int* kpos, float* dq,
    float* dk, float* dv, float* lse, float* drows, float* dk_part,
    float* dv_part, int B, int S, int T, int H, int Hkv, int hd, int hdv,
    float scale, int causal, int window, void* stream) {
  using namespace attn_bwd;
  if (hd > simt::kMaxDim || hdv > simt::kMaxDim || hd < 1 || hdv < 1 ||
      H % Hkv != 0 || S < 1 || T < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (tc::takes(q, k, v, out, dout, hd, hdv)) {
    if (H != Hkv && (dk_part == nullptr || dv_part == nullptr))
      return (int)cudaErrorInvalidValue;
    return tc::launch(q, k, v, out, dout, qpos, kpos, dq, dk, dv, lse, drows,
                      dk_part, dv_part, B, S, T, H, Hkv, hd, hdv, scale,
                      causal, window, st);
  }
  return simt::launch(q, k, v, out, dout, qpos, kpos, dq, dk, dv, lse, drows,
                      B, S, T, H, Hkv, hd, hdv, scale, causal, window, st);
}

