// One compressed ring gossip hop on each leaf of a group of node-stacked
// int8 payloads, optionally fused with the exact hop of an fp32 base:
//   w[i]   = wc (q[i] s[i]) + ws ((q[i-1] s[i-1]) + (q[i+1] s[i+1])),
//   out[i] = (wc h[i] + ws (h[i-1] + h[i+1])) + w[i]     (with a base h)
//   out[i] = w[i]                                         (without)
// neighbours wrapped mod n, one fp32 scale per node row.
//
// Replaces: src/repro/kernels/quant_mix.py, quant_mix_2d (_quant_mix_kernel),
// the fused dequantize + 3-way combine of (rows, cols) int8 panels; with a
// base, also the exact hop of the old public copies that the JAX engine adds
// to it (src/repro/comms/layer.py, _gossip_hats: mix_hop(hat_old) +
// quant_ring_hop(q), the identity W (hat + dq(q)) = W hat + W dq(q) of the
// TPU kernel's docstring).
//
// Bound on the H100: bytes.  Per element 1 byte of payload read and 4
// written, plus 4 read with a base, against 5 flops (9 with a base); the
// neighbour rows are read again by the blocks of the rows beside them,
// mostly from L2.  At the fair shapes an EF-int8 step's four trees are 2.1 M
// elements (about 5.5 us of HBM time), so what the card sees is the host's
// launches.
//
// Design: one launch per mixed tree (leaves.cuh): up to kMaxLeaves leaves
// with one node count, their descriptors passed by value; grid.y is the
// node row, grid.x holds each leaf's blocks in turn, and a leaf's blocks
// stride over its columns, four at a time (a 4-byte char4 load of int8, a
// 16-byte float4 load of the base and store of the result) where its row
// length and pointers allow, one at a time elsewhere (the 3-column y and v
// leaves).  The kernel reads the neighbours by wrapped row index, so no
// rolled copies are made.  Every operation is rounded on its own (__fmul_rn
// / __fadd_rn, so nvcc contracts nothing into an FMA) in the association
// of ring_mix.cu and of the first quant_mix kernel, so the fused result is
// bitwise the chain it replaces: ring_mix of the base, quant_mix of the
// payload, then their sum; and without a base, bitwise the plain
// wc*dq(q) + ws*(dq(roll(q, 1)) + dq(roll(q, -1))).
#include "leaves.cuh"

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocksPerLeaf = 1024;

struct QuantLeaf {
  const int8_t* q;     // (n, f) contiguous
  const float* s;      // (n,) scales
  const float* base;   // (n, f) contiguous, or null
  float* out;          // (n, f) contiguous
  long long f;         // columns of the leaf
  long long first;     // the leaf's first block in grid.x
  long long blocks;    // its blocks
  int vec;             // 4-column access allowed
};

struct QuantGroup {
  QuantLeaf leaf[kMaxLeaves];
  int count;
};

__device__ __forceinline__ float quant_combine(float qc, float sc, float ql,
                                               float sl, float qr, float sr,
                                               float wc, float ws) {
  return ring_combine(__fmul_rn(qc, sc), __fmul_rn(ql, sl), __fmul_rn(qr, sr),
                      wc, ws);
}

__global__ void __launch_bounds__(kThreads)
    quant_mix_group_kernel(const __grid_constant__ QuantGroup grp, int n,
                           float wc, float ws) {
  const QuantLeaf& l = grp.leaf[leaf_of(grp, blockIdx.x)];
  const long long start =
      (blockIdx.x - l.first) * (long long)kThreads + threadIdx.x;
  const long long stride = l.blocks * kThreads;
  const int i = blockIdx.y;
  const int il = i == 0 ? n - 1 : i - 1, ir = i == n - 1 ? 0 : i + 1;
  const float sc = l.s[i], sl = l.s[il], sr = l.s[ir];
  const bool base = l.base != nullptr;
  if (l.vec) {
    const long long f4 = l.f / 4;
    const char4* qc = reinterpret_cast<const char4*>(l.q) + (size_t)i * f4;
    const char4* ql = reinterpret_cast<const char4*>(l.q) + (size_t)il * f4;
    const char4* qr = reinterpret_cast<const char4*>(l.q) + (size_t)ir * f4;
    const float4* h = reinterpret_cast<const float4*>(l.base);
    float4* o = reinterpret_cast<float4*>(l.out) + (size_t)i * f4;
    for (long long c = start; c < f4; c += stride) {
      const char4 a = qc[c], lq = ql[c], rq = qr[c];
      float4 w = make_float4(
          quant_combine(a.x, sc, lq.x, sl, rq.x, sr, wc, ws),
          quant_combine(a.y, sc, lq.y, sl, rq.y, sr, wc, ws),
          quant_combine(a.z, sc, lq.z, sl, rq.z, sr, wc, ws),
          quant_combine(a.w, sc, lq.w, sl, rq.w, sr, wc, ws));
      if (base) {
        const float4 hc = h[(size_t)i * f4 + c], hl = h[(size_t)il * f4 + c],
                     hr = h[(size_t)ir * f4 + c];
        w = make_float4(
            __fadd_rn(ring_combine(hc.x, hl.x, hr.x, wc, ws), w.x),
            __fadd_rn(ring_combine(hc.y, hl.y, hr.y, wc, ws), w.y),
            __fadd_rn(ring_combine(hc.z, hl.z, hr.z, wc, ws), w.z),
            __fadd_rn(ring_combine(hc.w, hl.w, hr.w, wc, ws), w.w));
      }
      o[c] = w;
    }
  } else {
    const long long f = l.f;
    const int8_t* qc = l.q + (size_t)i * f;
    const int8_t* ql = l.q + (size_t)il * f;
    const int8_t* qr = l.q + (size_t)ir * f;
    float* o = l.out + (size_t)i * f;
    for (long long c = start; c < f; c += stride) {
      float w = quant_combine(qc[c], sc, ql[c], sl, qr[c], sr, wc, ws);
      if (base)
        w = __fadd_rn(ring_combine(l.base[(size_t)i * f + c],
                                   l.base[(size_t)il * f + c],
                                   l.base[(size_t)ir * f + c], wc, ws),
                      w);
      o[c] = w;
    }
  }
}

}  // namespace

// qs, ss, bases, outs, fs: count (1 <= count <= kMaxLeaves) leaves, leaf j
// an (n, fs[j]) contiguous int8 payload at qs[j] with n fp32 scales at
// ss[j], an optional (n, fs[j]) contiguous fp32 base at bases[j] (null for
// none) and an (n, fs[j]) fp32 output at outs[j]; n <= 65535.  One launch.
REPRO_API int repro_quant_mix(const int8_t* const* qs, const float* const* ss,
                              const float* const* bases, float* const* outs,
                              const long long* fs, int count, int n, float wc,
                              float ws, void* stream) {
  if (count < 1 || count > kMaxLeaves || n < 1)
    return (int)cudaErrorInvalidValue;
  QuantGroup grp = {};
  grp.count = count;
  long long total = 0;
  for (int j = 0; j < count; ++j) {
    QuantLeaf& l = grp.leaf[j];
    l.q = qs[j];
    l.s = ss[j];
    l.base = bases[j];
    l.out = outs[j];
    l.f = fs[j];
    l.vec = l.f % 4 == 0 && reinterpret_cast<uintptr_t>(l.q) % 4 == 0 &&
            reinterpret_cast<uintptr_t>(l.out) % 16 == 0 &&
            reinterpret_cast<uintptr_t>(l.base) % 16 == 0;
    const long long cols = l.vec ? l.f / 4 : l.f;
    long long b = (cols + kThreads - 1) / kThreads;
    l.blocks = b < 1 ? 1 : (b > kMaxBlocksPerLeaf ? kMaxBlocksPerLeaf : b);
    l.first = total;
    total += l.blocks;
  }
  const dim3 grid((unsigned)total, (unsigned)n);
  quant_mix_group_kernel<<<grid, kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(grp, n, wc,
                                                                ws);
  REPRO_LAUNCH_CHECK();
  return 0;
}

// The resources of the kernel at its one launch configuration.
REPRO_API int repro_quant_mix_resources(ReproResources* out) {
  return repro_resources(&quant_mix_group_kernel, kThreads, 0, 1, out);
}
