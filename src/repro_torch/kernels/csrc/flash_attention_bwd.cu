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
// dS k and dS^T q: 2 (3 hd + 2 hdv) flops, against each operand read
// once; fp32 on the CUDA cores (67 TFLOP/s).  This design does more: it
// computes q.k three times (row statistics, dq, dk/dv) and d_out.v twice.
//
// Design (simple and right first; wgmma and TMA are later work): two
// kernels, no atomics, every sum in a fixed order, so results repeat bit
// for bit.
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
#include <cfloat>
#include <climits>

#include "common.cuh"

namespace attn_bwd {

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

}  // namespace attn_bwd

// All operands contiguous fp32: q (B, S, H, hd), k (B, T, Hkv, hd), v
// (B, T, Hkv, hdv), out and d_out (B, S, H, hdv); positions (B, S) and
// (B, T) int32; outputs dq, dk, dv like q, k, v; scratch lse and D (B, H, S)
// fp32.  H % Hkv == 0, hd and hdv <= 128, B and H <= 65535, S, T >= 1.
// window <= 0: no window.  Two launches on `stream`.
REPRO_API int repro_flash_attention_bwd(
    const float* q, const float* k, const float* v, const float* out,
    const float* dout, const int* qpos, const int* kpos, float* dq,
    float* dk, float* dv, float* lse, float* drows, int B, int S, int T,
    int H, int Hkv, int hd, int hdv, float scale, int causal, int window,
    void* stream) {
  using namespace attn_bwd;
  if (hd > kMaxDim || hdv > kMaxDim || hd < 1 || hdv < 1 || H % Hkv != 0 ||
      S < 1 || T < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
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
