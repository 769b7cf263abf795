// The block-level pieces of the selection family (select_topk.cu): one
// block takes one row of n f32 values and finds its k largest, for any k,
// in the order the package uses everywhere (value descending, then index
// ascending).
//
//  1. radix_select: the k-th largest value as an order-preserving uint32
//     key (a float's bits, sign-flipped so that the integers order as the
//     floats do; -0 counts as +0), 8 bits a pass from the top, each pass a
//     256-bin histogram in shared memory of the values whose higher bits
//     match the prefix found so far. It also gives how many of the k equal
//     the k-th value (the rest lie above it).
//  2. compact: every value above the k-th, in any order, then the values
//     equal to it by ascending index (a block-wide scan of each stretch of
//     the row, taken only where a stretch holds one), until there are k.
//  3. bitonic_sort: the k members as 64-bit words (key << 32 | ~index),
//     sorted descending, which is value descending, index ascending.
//
// What bounds it: bytes. The row is read once a pass (four histogram
// passes and the compaction), the k members written once.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace rgs {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kBins = 256;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ uint32_t order_key(float f) {
  const uint32_t u = __float_as_uint(f == 0.0f ? 0.0f : f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float from_order_key(uint32_t k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

__device__ __forceinline__ uint64_t member(uint32_t key, int i) {
  return ((uint64_t)key << 32) | (uint32_t)~(uint32_t)i;
}

// Shared scratch of the three steps.
struct Scratch {
  uint32_t hist[kBins];
  int warp_count[kWarps];
  int digit, above, n_above;
};

// The order key of the k-th largest of row[0 .. n) (1 <= k <= n), and in
// `ties` how many of the k equal it. All threads of the block call it.
__device__ inline uint32_t radix_select(const float* __restrict__ row, int n,
                                       int k, Scratch& sc, int& ties) {
  const int lane = threadIdx.x & 31;
  uint32_t prefix = 0, mask = 0;
  int need = k;  // members still to find at or below the prefix
  for (int shift = 24; shift >= 0; shift -= 8) {
    for (int b = threadIdx.x; b < kBins; b += kThreads) sc.hist[b] = 0;
    __syncthreads();
    // equal digits of a warp add once: the values of a row are close,
    // so their high bits are mostly the same
    for (int base = 0; base < n; base += kThreads) {
      const int i = base + threadIdx.x;
      uint32_t key = 0;
      bool in = i < n;
      if (in) {
        key = order_key(__ldg(row + i));
        in = (key & mask) == prefix;
      }
      const uint32_t d = in ? (key >> shift) & 0xffu : kBins + lane;
      const unsigned peers = __match_any_sync(kFull, d);
      if (in && lane == __ffs(peers) - 1)
        atomicAdd(&sc.hist[d], (uint32_t)__popc(peers));
    }
    __syncthreads();
    // warp 0: lane l holds bins 8l .. 8l + 7; the bin where the count of
    // the bins above it first reaches `need`
    if (threadIdx.x < 32) {
      uint32_t h[8];
      int tot = 0;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        h[j] = sc.hist[8 * lane + j];
        tot += (int)h[j];
      }
      int suffix = tot;  // this lane's bins and those of the lanes above
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int v = __shfl_down_sync(kFull, suffix, off);
        if (lane + off < 32) suffix += v;
      }
      int above = suffix - tot;
#pragma unroll
      for (int j = 7; j >= 0; --j) {
        if (above < need && above + (int)h[j] >= need) {
          sc.digit = 8 * lane + j;
          sc.above = above;
        }
        above += (int)h[j];
      }
    }
    __syncthreads();
    prefix |= (uint32_t)sc.digit << shift;
    mask |= 0xffu << shift;
    need -= sc.above;
    __syncthreads();  // sc is rewritten by the next pass
  }
  ties = need;
  return prefix;
}

// Writes the k members of row[0 .. n) into out[0 .. k): the values above
// the k-th (key kth) at out[0 .. k - ties) in any order, then the first
// `ties` values equal to it by index. All threads of the block call it.
__device__ inline void compact(const float* __restrict__ row, int n, int k,
                               uint32_t kth, int ties, Scratch& sc,
                               uint64_t* out) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x / 32;
  if (threadIdx.x == 0) sc.n_above = 0;
  __syncthreads();
  int taken = 0;  // equal values taken so far (the same in every thread)
  for (int base = 0; base < n; base += kThreads) {
    const int i = base + threadIdx.x;
    const uint32_t key = i < n ? order_key(__ldg(row + i)) : 0;
    const bool above = i < n && key > kth;
    const bool eq = i < n && key == kth && taken < ties;
    if (above) out[atomicAdd(&sc.n_above, 1)] = member(key, i);
    if (!__syncthreads_or(eq)) continue;
    const unsigned bal = __ballot_sync(kFull, eq);
    if (lane == 0) sc.warp_count[warp] = __popc(bal);
    __syncthreads();
    int rank = __popc(bal & ((1u << lane) - 1u)), total = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int c = sc.warp_count[w];
      rank += w < warp ? c : 0;
      total += c;
    }
    if (eq && taken + rank < ties)
      out[k - ties + taken + rank] = member(key, i);
    taken += total;
  }
  __syncthreads();
}

// Sorts buf[0 .. p) descending, p a power of two. All threads of the block
// call it; buf is shared or global memory of this block alone.
__device__ inline void bitonic_sort(uint64_t* buf, int p) {
  for (int size = 2; size <= p; size <<= 1) {
    for (int stride = size / 2; stride > 0; stride >>= 1) {
      for (int t = threadIdx.x; t < p / 2; t += kThreads) {
        const int i = 2 * t - (t & (stride - 1));
        const int j = i + stride;
        const bool desc = (i & size) == 0;
        const uint64_t a = buf[i], b = buf[j];
        if ((a < b) == desc) {
          buf[i] = b;
          buf[j] = a;
        }
      }
      __syncthreads();
    }
  }
}

}  // namespace rgs
