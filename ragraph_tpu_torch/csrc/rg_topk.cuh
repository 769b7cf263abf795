// Exact top-k selection for kernels E and G (bucket_topk.cu): the counterpart
// of rg_mma.cuh for selection.
//
// Order. Entries are ranked by value descending, then index ascending, and a
// value of -3e38 (kNegInf) never enters a list: an exhausted slot reads
// (-3e38, 0). A warp selects the top-k of one column (E) or row (G), taking
// each lane's values in batches of loads, in ascending index order.
//
// WarpTopK<S>, k <= 32 * S (S = 1, 2, 4): one list for the whole warp, held
// in registers and sorted across the lanes by (value, index), 32 * S
// entries, position p in slot p / 32 of lane p % 32. Every index into a
// lane's S slots is a constant under #pragma unroll, so the list stays in
// registers (chip_smoke.py fails if ptxas reports a stack frame or a spill
// for these kernels). It is right-aligned: the first 32 * S - k positions
// hold sentinels that no value passes, so the k-th entry always sits in the
// last slot of lane 31 and is the exact filter. The lanes' values that pass
// it are found by a ballot; each is handed to every lane by a shuffle, and
// each lane shifts its S entries against its left neighbour's (one
// warp-parallel insert, no per-lane list and no merge).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "rg_tile.cuh"

namespace rgk {

using rg::kFull;
using rg::kNegInf;

// a before b: value descending, then index ascending
__device__ __forceinline__ bool before(float av, int ai, float bv, int bi) {
  return av > bv || (av == bv && ai < bi);
}

// ---- the selector ----------------------------------------------------------

template <int S>
struct WarpTopK {
  float v[S];  // position 32 j + lane
  int i[S];
  int k;
  float tv;  // the k-th entry, on every lane
  int ti;

  __device__ __forceinline__ void init(int k_) {
    const int lane = threadIdx.x & 31;
    k = k_;
#pragma unroll
    for (int j = 0; j < S; ++j) {
      const bool sentinel = 32 * j + lane < 32 * S - k;
      v[j] = sentinel ? INFINITY : kNegInf;
      i[j] = sentinel ? -1 : 0;
    }
    tv = kNegInf;
    ti = 0;
  }

  // (x, xi), the same on every lane, into the list if it comes before the
  // k-th entry
  __device__ __forceinline__ void insert(float x, int xi) {
    const int lane = threadIdx.x & 31;
    float pv[S];
    int pi[S];
#pragma unroll
    for (int j = 0; j < S; ++j) {  // the old entry one position up
      pv[j] = __shfl_up_sync(kFull, v[j], 1);
      pi[j] = __shfl_up_sync(kFull, i[j], 1);
      const float wv = __shfl_sync(kFull, v[j > 0 ? j - 1 : 0], 31);
      const int wi = __shfl_sync(kFull, i[j > 0 ? j - 1 : 0], 31);
      if (lane == 0) {
        pv[j] = j > 0 ? wv : INFINITY;
        pi[j] = j > 0 ? wi : -1;
      }
    }
#pragma unroll
    for (int j = 0; j < S; ++j) {
      const bool up = before(x, xi, pv[j], pi[j]);
      const bool here = before(x, xi, v[j], i[j]);
      v[j] = up ? pv[j] : (here ? x : v[j]);
      i[j] = up ? pi[j] : (here ? xi : i[j]);
    }
    tv = __shfl_sync(kFull, v[S - 1], 31);
    ti = __shfl_sync(kFull, i[S - 1], 31);
  }

  template <int N, class Index>
  __device__ __forceinline__ void take(const float (&buf)[N], Index idx) {
#pragma unroll
    for (int u = 0; u < N; ++u) {
      const int c = idx(u);
      unsigned todo = __ballot_sync(kFull, before(buf[u], c, tv, ti));
      while (todo) {
        const int src = __ffs(todo) - 1;
        todo &= todo - 1;
        const float x = __shfl_sync(kFull, buf[u], src);
        const int xi = __shfl_sync(kFull, c, src);
        if (before(x, xi, tv, ti)) insert(x, xi);
      }
    }
  }

  __device__ __forceinline__ void write(float* ov, int* oi) const {
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int j = 0; j < S; ++j) {
      const int t = 32 * j + lane - (32 * S - k);
      if (t >= 0) {
        ov[t] = v[j];
        oi[t] = i[j];
      }
    }
  }
};

// The selector for k <= KCAP (32, 64 or 128)
template <int KCAP>
using TopK = WarpTopK<KCAP / 32>;

// ---- copies ----------------------------------------------------------------

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// at most N of this thread's copy groups still in flight; a block barrier
// must follow before another thread reads what landed
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

}  // namespace rgk
