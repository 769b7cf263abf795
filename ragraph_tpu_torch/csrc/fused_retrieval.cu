// Exact fused cosine top-k (kernel C).
//
// Replaces ragraph_tpu/ops/pallas_retrieval.py::_kernel (with _insert_merge
// and _merge_topk): for L2-normalised bf16 queries (Q, E) and keys (R, E),
// the k best scores per query, sorted descending, with their key indices.
// Products of bf16 values are exact in f32 and are summed in f32 by the
// tensor cores (rg_mma.cuh), in their own order. Keys whose valid flag is 0
// never enter a list; a query with fewer than k valid keys gets (-3e38, 0)
// in its remaining slots. Ties go to the lowest key index, and within a run
// of equal scores the lower index comes first.
//
// What bounds it on an H100: operations. One 2,048-query chunk against
// R = 262,144 keys at E = 64 is 2*Q*R*E = 68.7 GFLOP, about 0.07 ms at the
// 989 TFLOP/s bf16 tensor-core rate, against 34 MB of input (0.01 ms). Past
// the product, the top-k filter looks at every one of the Q*R scores once,
// and each block re-reads its key range from L2 for its own queries.
//
// Design: on the TPU the R axis was a sequential grid dimension and one
// running top-k per query lived in VMEM across it. H100 blocks run in no
// order and carry nothing between them, so R is split across blocks too:
// block (x, y) holds 64 * kWG queries resident in shared memory and walks
// the y-th range of keys in tiles of 128, the next tile's cp.async copies in
// flight while the current one multiplies. Rows wider than 256 do not fit
// resident: the queries' and keys' 128-column chunks are staged together
// in a two-stage ring, a key tile one product per chunk into the same
// accumulators. Each warpgroup takes its 64
// queries' 64 x 128 score tile on the tensor cores (wgmma, rg_mma.cuh) and
// filters it where it lands, in the accumulator registers: a thread holds
// 32 scores of each of two queries and the current k-th score of both; one
// warp vote per four registers, then a ballot per register, pick out the
// few scores that reach it, and only those go into the query's sorted list
// of k (score, index) pairs in shared memory. For k <= 16 the four threads
// that hold a query's scores hand them, one at a time, to one of them,
// which inserts them by itself, so a warp fills its sixteen lists at once;
// longer lists are shifted by the whole warp, one score at a time. The
// list's order is (score descending, index ascending), compared explicitly,
// since a fragment's keys are not in ascending order; the filter lets equal
// scores through so that the insertion can order a tie. The score tile never
// goes to shared memory, and the (Q, R) scores never exist in device
// memory. A second, small launch merges the per-range sorted lists of each
// query (one warp per query, one lane per range) under the same order.
//
// The inserts are most of the time: each range climbs to its own k-th score
// from nothing. So the ranges of a query share what they reach: a block
// publishes each list's k-th score (atomicMax on an order-preserving int
// key, one int per query) and, a tile later, filters against the largest
// one published. The k-th score of a subset of the keys is at most the
// k-th score of all keys, so no key of the true top-k is filtered out, and
// a key that ties it still passes.

#include <math.h>

#include "rg_mma.cuh"
#include "rg_tile.cuh"

namespace {

constexpr int kBR = rgm::kTileN;  // keys per tile
constexpr int kMergeThreads = 256;
constexpr int kMergeWarps = kMergeThreads / 32;
using rg::kFull;
using rg::kNegInf;

// The block's shared memory: the alignment slack, rg_mma.cuh's ring of
// tiles and the (64 * wg, k) lists.
__host__ __device__ inline size_t smem_bytes(int wg, int e, int k) {
  return rgm::kAlign + rgm::ring_bytes(64 * wg, e) +
         (sizeof(float) + sizeof(int)) * (size_t)(64 * wg) * k;
}

// Lists of at most kLaneK entries are filled by one thread each (below);
// longer ones by the whole warp.
constexpr int kLaneK = 16;

// Insert (cur, idx) into the sorted list L / LI of length k, ordered by
// (score descending, index ascending), if it comes before the last entry:
// one thread walks up from the end, moving each worse entry down a slot.
// Returns the list's k-th score afterwards.
__device__ __noinline__ float lane_insert(float* L, int* LI, int k,
                                          float cur, int idx) {
  float last = L[k - 1];
  if (!(cur > last || (cur == last && idx < LI[k - 1]))) return last;
  int i = k - 1;
  for (; i > 0; --i) {
    const float s = L[i - 1];
    const int si = LI[i - 1];
    if (s > cur || (s == cur && si < idx)) break;
    L[i] = s;
    LI[i] = si;
    if (i == k - 1) last = s;
  }
  L[i] = cur;
  LI[i] = idx;
  return i == k - 1 ? cur : last;
}

// The same insert by a whole warp, for any k <= 128: lane l holds entries
// l, 32 + l, ...; the position by ballots, then a shift in shared memory.
// Called with the same arguments by all lanes.
__device__ __noinline__ float warp_insert(float* L, int* LI, int k,
                                          float cur, int idx) {
  const int lane = threadIdx.x & 31;
  const float last = L[k - 1];
  if (!(cur > last || (cur == last && idx < LI[k - 1]))) return last;
  int pos = 0;
  float hv[4];
  int hi[4];
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int i = 32 * u + lane;
    const bool in = i < k;
    hv[u] = in ? L[i] : kNegInf;
    hi[u] = in ? LI[i] : 0;
    if (32 * u < k)
      pos += __popc(__ballot_sync(
          kFull, in && (hv[u] > cur || (hv[u] == cur && hi[u] < idx))));
  }
  __syncwarp();
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int i = 32 * u + lane;
    if (i >= pos && i + 1 < k) {
      L[i + 1] = hv[u];
      LI[i + 1] = hi[u];
    }
  }
  if (lane == 0) {
    L[pos] = cur;
    LI[pos] = idx;
  }
  __syncwarp();
  return L[k - 1];
}

// An int whose order is the order of the floats, for atomicMax.
__device__ __forceinline__ int order_key(float f) {
  const int i = __float_as_int(f);
  return i >= 0 ? i : i ^ 0x7fffffff;
}

__device__ __forceinline__ float from_order_key(int i) {
  return __int_as_float(i >= 0 ? i : i ^ 0x7fffffff);
}

// kWG warpgroups, 64 queries each, share every key tile of rg_mma.cuh's
// TileWalk over the block's range of keys (kChunk: rows wider than
// rgm::kResidentE).
template <int kWG, bool kChunk>
__global__ void __launch_bounds__(128 * kWG, 4 / kWG)
topk_partial_kernel(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ keys,
                    const uint8_t* __restrict__ valid,
                    float* __restrict__ part_s, int* __restrict__ part_i,
                    int* __restrict__ bound, int n_q, int n_r, int e, int k,
                    int splits, int rows_per_split) {
  constexpr int kThreads = 128 * kWG;
  constexpr int kBQ = 64 * kWG;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = rgm::aligned_smem(smem_raw);
  float* ls = reinterpret_cast<float*>(smem + rgm::ring_bytes(kBQ, e));
  int* li = reinterpret_cast<int*>(ls + kBQ * k);  // (BQ, k) lists

  const int q0 = blockIdx.x * kBQ;
  const int split = blockIdx.y;
  const long long r_begin = (long long)split * rows_per_split;
  const long long r_end = min((long long)n_r, r_begin + rows_per_split);
  const int n_tiles = (int)((r_end - r_begin + kBR - 1) / kBR);
  const int tid = threadIdx.x;
  const int warp = tid / 32;  // query rows 16 * warp .. 16 * warp + 15
  const int lane = tid & 31;
  const int wg = warp / 4;

  rgm::TileWalk<kThreads, kBQ, kChunk> walk(smem, q, keys, q0, n_q, r_begin,
                                            r_end, n_tiles, e);
  walk.start();
  for (int t = tid; t < kBQ * k; t += kThreads) {
    ls[t] = kNegInf;
    li[t] = 0;
  }
  // this thread's two queries (accumulator rows h = 0, 1): the larger of
  // the list's k-th score and the shared bound (shr), against which the
  // scores are filtered; a query past Q never passes the filter
  const int row0 = 16 * warp + (lane >> 2);
  float thr[2], shr[2] = {kNegInf, kNegInf};
  int next_bound[2];
  bool live_q[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    live_q[h] = q0 + row0 + 8 * h < n_q;
    thr[h] = live_q[h] ? kNegInf : INFINITY;
    next_bound[h] = order_key(kNegInf);
  }
  // the live flags of the next tile's keys, 4 per lane
  auto flags = [&](long long r0, bool (&f)[4]) {
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const long long gr = r0 + 32 * u + lane;
      f[u] = gr < r_end && (valid == nullptr || valid[gr] != 0);
    }
  };
  bool nf[4];
  flags(r_begin, nf);

  for (int t = 0; t < n_tiles; ++t) {
    const long long r0 = r_begin + (long long)t * kBR;
    walk.begin(t);
    // the bound read a tile ago, and the read for the next tile
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      shr[h] = fmaxf(shr[h], from_order_key(next_bound[h]));
      thr[h] = fmaxf(thr[h], shr[h]);
      if (live_q[h]) next_bound[h] = __ldcg(bound + q0 + row0 + 8 * h);
    }
    // bit b of word u: key r0 + 32u + b is live; shifted to this thread's
    // first column 2 * (lane % 4)
    unsigned word[4], all = kFull, some = 0;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const unsigned w = __ballot_sync(kFull, nf[u]);
      all &= w;
      some |= w;
      word[u] = w >> (2 * (lane & 3));
    }
    const bool all_live = all == kFull;
    const bool any_live = some != 0;
    if (t + 1 < n_tiles) flags(r0 + kBR, nf);

    float acc[rgm::kAcc];
    walk.product(acc, t, 64 * wg);

    // keys past the range or not valid score -inf and never pass; a tile
    // with no live key is skipped
    if (!all_live) {
#pragma unroll
      for (int v = 0; v < rgm::kAcc; ++v) {
        const int j = v >> 2;  // key columns 8j .. 8j+7
        if (!((word[j >> 2] >> ((8 * j) % 32 + (v & 1))) & 1u))
          acc[v] = -INFINITY;
      }
    }
    if (any_live && q0 + 16 * warp < n_q) {
#pragma unroll
      for (int j = 0; j < rgm::kAcc / 4; ++j) {
        // keys 8j + 2 * (lane % 4) + x of query rows row0 + 8h sit in
        // acc[4j + 2h + x]: one vote for the four, then one per score
        if (!__any_sync(kFull, acc[4 * j] >= thr[0] ||
                                   acc[4 * j + 1] >= thr[0] ||
                                   acc[4 * j + 2] >= thr[1] ||
                                   acc[4 * j + 3] >= thr[1]))
          continue;
#pragma unroll 1
        for (int x = 0; x < 2; ++x) {
          const float s0 = x ? acc[4 * j + 1] : acc[4 * j];
          const float s1 = x ? acc[4 * j + 3] : acc[4 * j + 2];
          const int key = (int)r0 + 8 * j + x;  // + 2 * (lane % 4)
          unsigned m0 = __ballot_sync(kFull, s0 >= thr[0]);
          unsigned m1 = __ballot_sync(kFull, s1 >= thr[1]);
          if (k <= kLaneK) {
            // each quad hands its lowest pending score of each of its two
            // queries to the lane that owns that query (lanes 4 * (lane /
            // 4) + h): the warp fills its sixteen lists at once
            const int base = lane & ~3;
            const int own = lane & 3;
            while (m0 | m1) {
              const unsigned p0 = (m0 >> base) & 0xFu;
              const unsigned p1 = (m1 >> base) & 0xFu;
              const int src0 = p0 ? base + __ffs(p0) - 1 : lane;
              const int src1 = p1 ? base + __ffs(p1) - 1 : lane;
              const float c0 = __shfl_sync(kFull, s0, src0);
              const float c1 = __shfl_sync(kFull, s1, src1);
              float kth = own == 0 ? thr[0] : thr[1];
              if (own < 2 && (own ? p1 : p0)) {
                const int ql = row0 + 8 * own;
                kth = lane_insert(ls + ql * k, li + ql * k, k,
                                  own ? c1 : c0,
                                  key + 2 * ((own ? src1 : src0) & 3));
                if (kth > kNegInf) atomicMax(bound + q0 + ql, order_key(kth));
                kth = fmaxf(kth, own ? shr[1] : shr[0]);
              }
              m0 &= ~__ballot_sync(kFull, p0 && lane == src0);
              m1 &= ~__ballot_sync(kFull, p1 && lane == src1);
              thr[0] = __shfl_sync(kFull, kth, base);
              thr[1] = __shfl_sync(kFull, kth, base + 1);
            }
          } else {
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              unsigned m = h ? m1 : m0;
              const float s = h ? s1 : s0;
              while (m) {
                const int src = __ffs(m) - 1;
                m &= m - 1;
                const float cur = __shfl_sync(kFull, s, src);
                const int ql = 16 * warp + (src >> 2) + 8 * h;
                const float kth = warp_insert(ls + ql * k, li + ql * k, k,
                                              cur, key + 2 * (src & 3));
                if (lane == src && kth > kNegInf)
                  atomicMax(bound + q0 + ql, order_key(kth));
                if ((lane >> 2) == (src >> 2)) thr[h] = fmaxf(kth, shr[h]);
              }
            }
          }
        }
      }
    }
  }
  __syncthreads();

  for (int t = tid; t < kBQ * k; t += kThreads) {
    const int ql = t / k;
    const int i = t - ql * k;
    if (q0 + ql < n_q) {
      const long long o = ((long long)(q0 + ql) * splits + split) * k + i;
      part_s[o] = ls[t];
      part_i[o] = li[t];
    }
  }
}

// One warp per query: lane l holds the head of range l's sorted list; k
// rounds of a warp arg-max under (score descending, index ascending).
__global__ void __launch_bounds__(kMergeThreads)
topk_merge_kernel(const float* __restrict__ part_s,
                  const int* __restrict__ part_i, float* __restrict__ out_s,
                  int* __restrict__ out_i, int n_q, int splits, int k) {
  const int gq = blockIdx.x * kMergeWarps + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (gq >= n_q) return;
  const float* ps = part_s + (long long)gq * splits * k;
  const int* pi = part_i + (long long)gq * splits * k;
  int head = 0;
  float hs = -INFINITY;
  int hi = INT32_MAX;
  if (lane < splits) {
    hs = ps[lane * k];
    hi = pi[lane * k];
  }
  for (int t = 0; t < k; ++t) {
    float bs = hs;
    int bi = hi;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float os = __shfl_xor_sync(kFull, bs, off);
      const int oi = __shfl_xor_sync(kFull, bi, off);
      if (os > bs || (os == bs && oi < bi)) {
        bs = os;
        bi = oi;
      }
    }
    const unsigned m = __ballot_sync(kFull, hs == bs && hi == bi);
    if (lane == 0) {
      out_s[(long long)gq * k + t] = bs;
      out_i[(long long)gq * k + t] = bi;
    }
    if (lane == __ffs(m) - 1) {
      ++head;
      if (head < k) {
        hs = ps[lane * k + head];
        hi = pi[lane * k + head];
      } else {
        hs = -INFINITY;
        hi = INT32_MAX;
      }
    }
  }
}

template <int kWG, bool kChunk>
cudaError_t launch_partial(const dim3& grid, size_t smem, cudaStream_t s,
                           const __nv_bfloat16* q, const __nv_bfloat16* keys,
                           const uint8_t* valid, float* part_s, int* part_i,
                           int* bound, int n_q, int n_r, int e, int k,
                           int splits, int rows_per_split) {
  cudaError_t err = cudaFuncSetAttribute(
      topk_partial_kernel<kWG, kChunk>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  topk_partial_kernel<kWG, kChunk><<<grid, 128 * kWG, smem, s>>>(
      q, keys, valid, part_s, part_i, bound, n_q, n_r, e, k, splits,
      rows_per_split);
  return cudaGetLastError();
}

template <int kWG>
cudaError_t launch_partial(bool chunk, const dim3& grid, size_t smem,
                           cudaStream_t s, const __nv_bfloat16* q,
                           const __nv_bfloat16* keys, const uint8_t* valid,
                           float* part_s, int* part_i, int* bound, int n_q,
                           int n_r, int e, int k, int splits,
                           int rows_per_split) {
  return chunk ? launch_partial<kWG, true>(grid, smem, s, q, keys, valid,
                                           part_s, part_i, bound, n_q, n_r,
                                           e, k, splits, rows_per_split)
               : launch_partial<kWG, false>(grid, smem, s, q, keys, valid,
                                            part_s, part_i, bound, n_q, n_r,
                                            e, k, splits, rows_per_split);
}

}  // namespace

extern "C" {

// q (Q, E) and keys (R, E) bf16, row-major, 16-byte aligned, E % 8 == 0
// (rows wider than 256 in chunks of 128 columns); valid (R,) uint8 or null;
// 1 <= k <= 128 (a larger k takes the selection family, select_topk.cu);
// block_q 64 or 128
// queries per block; 1 <= splits <= 32 ranges of rows_per_split keys (a
// multiple of 128). Scratch part_s / part_i hold (Q, splits, k), bound (Q,)
// int32; out_s / out_i are (Q, k).
int rg_fused_cosine_topk(const void* q, const void* keys, const void* valid,
                         void* part_s, void* part_i, void* bound,
                         void* out_s, void* out_i, int n_q, int n_r, int e,
                         int k, int block_q, int splits, int rows_per_split,
                         void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_q == 0) return (int)cudaGetLastError();
  if ((block_q != 64 && block_q != 128) || splits < 1 || splits > 32 ||
      rows_per_split % kBR != 0)
    return (int)cudaErrorInvalidValue;
  const int wg = block_q / 64;
  const dim3 grid((n_q + block_q - 1) / block_q, splits);
  const auto* qh = static_cast<const __nv_bfloat16*>(q);
  const auto* kh = static_cast<const __nv_bfloat16*>(keys);
  const auto* vb = static_cast<const uint8_t*>(valid);
  auto* ps = static_cast<float*>(part_s);
  auto* pi = static_cast<int*>(part_i);
  auto* bd = static_cast<int*>(bound);
  // bytes 0x80: the order key of -3.4e38, below every score
  cudaError_t err = cudaMemsetAsync(bd, 0x80, sizeof(int) * (size_t)n_q, s);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = smem_bytes(wg, e, k);
  const bool chunk = rgm::chunked(e);
  err = wg == 2 ? launch_partial<2>(chunk, grid, smem, s, qh, kh, vb, ps, pi,
                                    bd, n_q, n_r, e, k, splits,
                                    rows_per_split)
                : launch_partial<1>(chunk, grid, smem, s, qh, kh, vb, ps, pi,
                                    bd, n_q, n_r, e, k, splits,
                                    rows_per_split);
  if (err != cudaSuccess) return (int)err;
  topk_merge_kernel<<<(n_q + kMergeWarps - 1) / kMergeWarps, kMergeThreads, 0,
                      s>>>(ps, pi, static_cast<float*>(out_s),
                           static_cast<int*>(out_i), n_q, splits, k);
  return (int)cudaGetLastError();
}

}  // extern "C"
