// A group of node-stacked leaves mixed by one launch (ring_mix.cu,
// multi_hop_mix.cu; multi_hop_mix_quant.cu has a group of its own and
// shares leaf_of).
//
// A mixed tree (the x of one optimizer step: four leaves of 72 to 50176
// columns) used to cost one launch per leaf, and each launch its own host
// work.  Here up to kMaxLeaves leaves with the same node count share one
// launch.  Their descriptors travel by value, as a kernel parameter
// (__grid_constant__, read from the parameter bank): no descriptor tensor
// and no host-to-device copy.  Leaf j owns the blocks [first, first +
// blocks) of grid.x, and a block finds its leaf from that prefix of block
// counts.
#pragma once

#include "common.cuh"

constexpr int kMaxLeaves = 16;   // ops.py's MAX_LEAVES

struct Leaf {
  const float* x;     // (n, f) contiguous
  float* out;         // (n, f) contiguous
  long long f;        // columns of the leaf
  long long first;    // the leaf's first block in grid.x
  long long blocks;   // its blocks
  int vec;            // float4 access allowed (ring_mix)
};

struct LeafGroup {
  Leaf leaf[kMaxLeaves];
  int count;
};

// The leaf that owns grid block b: the last leaf whose first block is <= b.
// The loop is unrolled and its indices are constants, so it reads the
// parameter bank directly; the branch is uniform across the block.  Any
// group with leaf[kMaxLeaves].first and count.
template <class Group>
__device__ __forceinline__ int leaf_of(const Group& g, long long b) {
  int j = 0;
#pragma unroll
  for (int k = 1; k < kMaxLeaves; ++k)
    if (k < g.count && b >= g.leaf[k].first) j = k;
  return j;
}

// Fills g from the C entry's arrays with each leaf's block count from
// blocks_of(leaf); returns the total, or -1 for a count outside
// [1, kMaxLeaves].
template <typename BlocksOf>
inline long long fill_group(LeafGroup& g, const float* const* xs,
                            float* const* outs, const long long* fs,
                            int count, BlocksOf blocks_of) {
  if (count < 1 || count > kMaxLeaves) return -1;
  g = LeafGroup{};
  g.count = count;
  long long total = 0;
  for (int j = 0; j < count; ++j) {
    Leaf& l = g.leaf[j];
    l.x = xs[j];
    l.out = outs[j];
    l.f = fs[j];
    l.first = total;
    l.blocks = blocks_of(l);
    total += l.blocks;
  }
  return total;
}
