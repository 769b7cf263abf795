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
// What bounds it on an H100. At an edge finetune step (Q = R = 238,735,
// E = 64) the product is 2*Q*R*E = 7.3 TFLOP, 7.4 ms at the 989 TFLOP/s
// bf16 tensor-core rate, against 61 MB of input. Past the product, the top-k
// filter looks at every one of the Q*R scores once, and each block re-reads
// its key range from L2 for its own queries (30.6 MB a block there).
//
// Design. On the TPU the R axis was a sequential grid dimension and one
// running top-k per query lived in VMEM across it. H100 blocks run in no
// order and carry nothing between them, so where the queries alone do not
// fill the card R is split across blocks too: block (x, y) holds 64 queries
// and walks the y-th range of keys in tiles of 128.
//
// Roles. A block is one consumer warpgroup (64 queries, 16 a warp) and one
// producer warpgroup; two blocks share an SM. The producer's first lane
// stages the key tiles into a ring of shared memory by TMA
// (cp.async.bulk.tensor: the hardware writes rg_mma.cuh's 128-byte swizzle
// and zero-fills rows and columns past the matrix): rows of at most 64
// values in 5 stages of one key tile, of at most 128 in 2, both under the
// resident query tile; wider rows in 3 stages of (query, key) pairs of
// 128-column pieces. Each stage has a full mbarrier (the producer's
// expect_tx, completed by the copies' bytes) and an empty one (one arrival
// a consumer warp once the warpgroup's wgmma has read it). The consumers
// wait only on the stages they read; the tile loop has no block barrier.
//
// Registers. An SM's register file is four quarters of 16,384, one a warp
// scheduler; two blocks of 256 threads start at 128 registers a thread.
// The producer keeps 24 (setmaxnreg) and each consumer takes 232: a
// consumer thread holds two sets of 64 scores.
//
// Pipeline. Rows of at most 128 values: when tile t's wgmma group has
// completed, the consumer moves its scores to the second set, frees the
// stage, issues tile t+1's wgmma into the first set and filters tile t
// from the second while the tensor cores work on t+1. (Two accumulator
// sets taken by wgmma in turn need the filter inlined twice; that version
// measured slower on the card.) Wider rows: a tile's pieces stream through the three stages,
// each one wgmma group, and the filter follows the tile's last piece (the
// product is twice the filter's work or more there). The k16 steps are
// those of rg_mma.cuh's mma_row, in its order, so C's scores are bit for
// bit the score matrix's and kernel D's.
//
// Filter. A thread holds 32 scores of each of two queries and the current
// k-th score of both (the threshold). It takes the maximum of each query's
// 32 scores by a branch-free fmaxf tree and compares the two with its
// thresholds; the warp takes one vote. Only a warp-tile whose vote passes
// goes on: one reduction finds the groups of four registers that hold a
// passing score, a ballot per register picks out the few that reach it,
// and only those go into the query's list of k (score, index) pairs in
// shared memory. For k <= 16 the four threads that hold a query's scores
// hand them, one at a time, to one of them, which keeps the list by
// itself, so a warp fills its sixteen lists at once: the list stays
// unsorted, the thread tracks its worst entry, a better score takes that
// slot, and one pass over the list (float4 reads) finds the next worst.
// Longer lists are kept sorted and shifted by the whole warp, one score at
// a time. The order is (score descending, index ascending), compared
// explicitly, since a fragment's keys are not in ascending order; the
// filter lets equal scores through so that the insertion can order a tie.
// Keys past the range or not valid score -inf and never pass. The score
// tile never goes to shared memory, and the (Q, R) scores never exist in
// device memory. Each warp counts the warp-tiles whose vote passed and adds
// them to a counter once, at the end.
//
// Ranges. Each range climbs to its own k-th score from nothing, so the
// ranges of a query share what they reach: a block publishes each list's
// k-th score (atomicMax on an order-preserving unsigned key, one a query)
// and, a tile later, filters against the largest one published. The k-th
// score of a subset of the keys is at most the k-th score of all keys, so
// no key of the true top-k is filtered out, and a key that ties it still
// passes. A second, small launch merges the per-range sorted lists of each
// query (one warp per query, one lane per range) under the same order.
//
// What bounds the kernel now (one H100, finetune shape): the key stream
// and wgmma alone take 13-15 ms, the vote another 6; the rest is the
// passing warp-tiles, a quarter of them at k = 10, whose inserts hold up
// the other three warps of the warpgroup at the next wgmma.

#include <cuda.h>
#include <dlfcn.h>
#include <math.h>

#include "rg_mma.cuh"
#include "rg_tile.cuh"

namespace {

constexpr int kBR = rgm::kTileN;      // keys per tile
constexpr int kBQ = rgm::kTileM;      // queries per block: one warpgroup
constexpr int kThreads = 256;         // the consumer and producer warpgroups
constexpr int kPieceE = rgm::kChunkE;  // columns of a ring piece
constexpr int kBoxE = 64;             // columns of a TMA box: one swizzle atom
constexpr int kMergeThreads = 256;
constexpr int kMergeWarps = kMergeThreads / 32;
using rg::kFull;
using rg::kNegInf;

// How a row of e values is staged: kNarrow, at most 64 columns, a key tile
// a stage in 5 stages; kResident, at most 128 columns, in 2 (so that two
// blocks fit an SM); both under the resident query tile. kChunked, wider
// rows: (query, key) pairs of 128-column pieces in 3 stages.
enum Mode { kNarrow = 0, kResident = 1, kChunked = 2 };

__host__ __device__ inline int mode(int e) {
  return e <= 64 ? kNarrow : e <= kPieceE ? kResident : kChunked;
}

__host__ __device__ constexpr int ring_stages(int m) {
  return m == kNarrow ? 5 : m == kResident ? 2 : 3;
}

// 128-column pieces of a row of e values, and the width of piece c.
__host__ __device__ inline int n_pieces(int e) {
  return (e + kPieceE - 1) / kPieceE;
}
__host__ __device__ inline int piece_w(int e, int c) {
  return e - c * kPieceE < kPieceE ? e - c * kPieceE : kPieceE;
}

// Swizzle atoms (64 columns, one TMA box each) of a tile of width w.
__host__ __device__ inline int atoms(int w) {
  return (rgm::padded_width(w) + kBoxE - 1) / kBoxE;
}

// Bytes of the resident query tile (0 for wide rows) and of a stage.
__host__ __device__ inline size_t query_tile_bytes(int bq, int e) {
  return mode(e) == kChunked ? 0 : rgm::tile_bytes(bq, e);
}
__host__ __device__ inline size_t stage_bytes(int bq, int e) {
  const int w = e < kPieceE ? e : kPieceE;
  return (mode(e) == kChunked ? rgm::tile_bytes(bq, w) : 0) +
         rgm::tile_bytes(kBR, w);
}

// The block's shared memory: the alignment slack, the query tile, the
// ring, the (kBQ, k) lists in rows of k rounded up to 4 and a full and an
// empty mbarrier a stage.
__host__ __device__ inline size_t smem_bytes(int e, int k) {
  const int stages = ring_stages(mode(e));
  return rgm::kAlign + query_tile_bytes(kBQ, e) +
         stages * stage_bytes(kBQ, e) +
         (sizeof(float) + sizeof(int)) * (size_t)kBQ * ((k + 3) & ~3) +
         16 * stages;
}

// Lists of at most kLaneK entries are filled by one thread each (below);
// longer ones by the whole warp.
constexpr int kLaneK = 16;

// --- mbarriers and TMA --------------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

// Wait until the phase of parity `parity` of the mbarrier has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Arrive and expect `bytes` of copies before the phase completes.
__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

// One TMA box (kBoxE columns from `col`, the map's box rows from `row`)
// into the swizzle atom at shared address `dst`, completing on `bar`.
__device__ __forceinline__ void tma_box(const CUtensorMap& map, uint32_t dst,
                                        int col, int row, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(&map)), "r"(bar), "r"(col), "r"(row)
      : "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// One k16 step of the 64 x 128 tile: A's and B's 16 columns at the shared
// addresses a and b (as rg_mma.cuh's mma_tile addresses them).
__device__ __forceinline__ void wgmma_step(float (&d)[rgm::kAcc], uint32_t a,
                                           uint32_t b, bool accumulate) {
  rgm::wgmma_m64n128k16(d, rgm::descriptor(a), rgm::descriptor(b),
                        accumulate);
}

// --- lists ---------------------------------------------------------------

// Lists of k <= kLaneK stay unsorted while they fill, their worst entry
// (the last under (score descending, index ascending)) tracked in the
// registers of the lane that owns the list: (cur, idx), which comes before
// it, takes its slot, and one pass over the list, read as float4 and int4,
// finds the new worst. L and LI are 16-byte aligned. Returns the list's
// k-th score, the new worst's.
__device__ __forceinline__ float lane_replace(float* L, int* LI, int k,
                                              float cur, int idx, int& wpos,
                                              float& wsc, int& wid) {
  L[wpos] = cur;
  LI[wpos] = idx;
  float ws = INFINITY;
  int wi = 0, wp = 0;
  for (int i = 0; i < k; i += 4) {
    const float4 s4 = *reinterpret_cast<const float4*>(L + i);
    const int4 i4 = *reinterpret_cast<const int4*>(LI + i);
    const float sv[4] = {s4.x, s4.y, s4.z, s4.w};
    const int iv[4] = {i4.x, i4.y, i4.z, i4.w};
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const bool worse =
          i + u < k && (sv[u] < ws || (sv[u] == ws && iv[u] > wi));
      ws = worse ? sv[u] : ws;
      wi = worse ? iv[u] : wi;
      wp = worse ? i + u : wp;
    }
  }
  wpos = wp;
  wsc = ws;
  wid = wi;
  return ws;
}

// Sort a list of k (score, index) pairs into (score descending, index
// ascending) order, by one thread.
__device__ __forceinline__ void sort_list(float* L, int* LI, int k) {
  for (int i = 1; i < k; ++i) {
    const float s = L[i];
    const int si = LI[i];
    int j = i;
    for (; j > 0 && (L[j - 1] < s || (L[j - 1] == s && LI[j - 1] > si));
         --j) {
      L[j] = L[j - 1];
      LI[j] = LI[j - 1];
    }
    L[j] = s;
    LI[j] = si;
  }
}

// The same insert by a whole warp, for any k <= 128: lane l holds entries
// l, 32 + l, ...; the position by ballots, then a shift in shared memory.
// Called with the same arguments by all lanes.
__device__ __forceinline__ float warp_insert(float* L, int* LI, int k,
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

// An unsigned whose order is the order of the floats, for atomicMax; 0,
// the bound's value before any publication, decodes to a NaN, which fmaxf
// passes over.
__device__ __forceinline__ unsigned order_key(float f) {
  const unsigned u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float from_order_key(unsigned u) {
  return __uint_as_float((u & 0x80000000u) ? (u & 0x7fffffffu) : ~u);
}

// --- the ring ------------------------------------------------------------

// Where the block's tiles and barriers sit in shared memory.
struct Ring {
  uint32_t q;       // the resident query tile (rows of at most 128 values)
  uint32_t first;   // stage 0
  uint32_t stage;   // bytes of a stage
  uint32_t qpiece;  // bytes of a stage's query piece (wider rows), else 0
  uint32_t full;    // stage s's full mbarrier at full + 8 s
  uint32_t empty;   // and its empty one at empty + 8 s
  int e, pieces;    // row width; pieces of a key tile

  __device__ uint32_t at(int s) const { return first + s * stage; }
};

// One consumer thread's state: its warp's 16 queries' lists, thresholds
// and shared bounds, the live flags of the next tile, and the count of
// warp-tiles whose vote passed.
struct Filter {
  float* ls;
  int* li;
  unsigned* bound;
  const uint8_t* valid;
  int r_begin, r_end;  // the block's range of keys
  int n_tiles, k, kp, q0, row0, lane;  // kp: a list's stride
  bool share, live_warp;
  bool live_q[2], nf[4];
  float thr[2], shr[2];
  unsigned next_bound[2];
  unsigned passes;
  int wpos, wid;  // k <= kLaneK, lanes 4 * (lane / 4) + h: the worst entry
  float wsc;      // of query row0 + 8h's list

  // the live flags of the keys of the tile at r0, 4 per lane
  __device__ __forceinline__ void flags(int r0) {
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int gr = r0 + 32 * u + lane;
      nf[u] = gr < r_end && (valid == nullptr || valid[gr] != 0);
    }
  }

  // Whether score v of this thread's tile fragment has a live key, by the
  // tile's live words (bit b of word u: key 32u + b, shifted to this
  // thread's first column 2 * (lane % 4)).
  __device__ __forceinline__ static bool live(const unsigned (&word)[4],
                                              int v) {
    const int j = v >> 2;  // key columns 8j .. 8j+7
    return (word[j >> 2] >> ((8 * j) % 32 + (v & 1))) & 1u;
  }

  // The maximum of each of the thread's two queries' 32 scores, in four
  // chains a query; kMasked: scores of keys that are not live count as
  // -inf. Keys 8j + 2 * (lane % 4) + x of query rows row0 + 8h sit in
  // d[4j + 2h + x].
  template <bool kMasked>
  __device__ __forceinline__ static void maxima(const float (&d)[rgm::kAcc],
                                                const unsigned (&word)[4],
                                                float& m0, float& m1) {
    auto sc = [&](int v) {
      return !kMasked || live(word, v) ? d[v] : -INFINITY;
    };
    float m[2][4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      m[0][c] = fmaxf(sc(4 * c), sc(4 * c + 1));
      m[1][c] = fmaxf(sc(4 * c + 2), sc(4 * c + 3));
    }
#pragma unroll
    for (int j = 4; j < 16; ++j) {
      m[0][j & 3] = fmaxf(m[0][j & 3], fmaxf(sc(4 * j), sc(4 * j + 1)));
      m[1][j & 3] = fmaxf(m[1][j & 3], fmaxf(sc(4 * j + 2), sc(4 * j + 3)));
    }
    m0 = fmaxf(fmaxf(m[0][0], m[0][1]), fmaxf(m[0][2], m[0][3]));
    m1 = fmaxf(fmaxf(m[1][0], m[1][1]), fmaxf(m[1][2], m[1][3]));
  }

  // Filter key tile t's scores d (the accumulator layout of rg_mma.cuh's
  // mma_tile) into the lists. d is only read: keys past the range or not
  // valid are masked where their scores are read.
  __device__ __forceinline__ void tile(const float (&d)[rgm::kAcc], int t) {
    const int r0 = r_begin + t * kBR;
    // the bound read a tile ago, and the read for the next tile
    if (share) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        shr[h] = fmaxf(shr[h], from_order_key(next_bound[h]));
        thr[h] = fmaxf(thr[h], shr[h]);
        if (live_q[h]) next_bound[h] = __ldcg(bound + q0 + row0 + 8 * h);
      }
    }
    unsigned word[4], all = kFull, some = 0;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const unsigned w = __ballot_sync(kFull, nf[u]);
      all &= w;
      some |= w;
      word[u] = w >> (2 * (lane & 3));
    }
    if (t + 1 < n_tiles) flags(r0 + kBR);
    if (some == 0 || !live_warp) return;
    // one vote on the maxima
    const bool masked = all != kFull;
    float m0, m1;
    if (masked)
      maxima<true>(d, word, m0, m1);
    else
      maxima<false>(d, word, m0, m1);
    if (!__any_sync(kFull, m0 >= thr[0] || m1 >= thr[1])) return;
    ++passes;
    auto sc = [&](int v) {
      return !masked || live(word, v) ? d[v] : -INFINITY;
    };
    // the groups of four registers that hold a passing score: this
    // thread's by compares alone, then the warp's by one reduction
    unsigned mine = 0;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const bool p = (sc(4 * j) >= thr[0]) | (sc(4 * j + 1) >= thr[0]) |
                     (sc(4 * j + 2) >= thr[1]) | (sc(4 * j + 3) >= thr[1]);
      mine |= (unsigned)p << j;
    }
    unsigned groups = __reduce_or_sync(kFull, mine);
    while (groups) {
      const int j = __ffs(groups) - 1;
      groups &= groups - 1;
      float g[4];
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        g[v] = pick(d, j, v);
        if (masked) {
          const unsigned w = j < 8 ? (j < 4 ? word[0] : word[1])
                                   : (j < 12 ? word[2] : word[3]);
          g[v] = (w >> ((8 * j) % 32 + (v & 1))) & 1u ? g[v] : -INFINITY;
        }
      }
#pragma unroll 1
      for (int x = 0; x < 2; ++x) {
        const float s0 = x ? g[1] : g[0];
        const float s1 = x ? g[3] : g[2];
        const int key = r0 + 8 * j + x;  // + 2 * (lane % 4)
        insert(s0, s1, key);
      }
    }
  }

  // d[4j + v] for a j known only at run time: a tree of selects on the
  // bits of j, which keeps d in registers.
  __device__ __forceinline__ static float pick(const float (&d)[rgm::kAcc],
                                               int j, int v) {
    float a[8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
      a[i] = (j & 1) ? d[4 * (2 * i + 1) + v] : d[4 * (2 * i) + v];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = (j & 2) ? a[2 * i + 1] : a[2 * i];
#pragma unroll
    for (int i = 0; i < 2; ++i) a[i] = (j & 4) ? a[2 * i + 1] : a[2 * i];
    return (j & 8) ? a[1] : a[0];
  }

  // Insert the scores s0, s1 (this thread's of query rows row0, row0 + 8,
  // at key + 2 * (lane % 4)) that reach their threshold.
  __device__ __forceinline__ void insert(float s0, float s1, int key) {
    unsigned m0 = __ballot_sync(kFull, s0 >= thr[0]);
    unsigned m1 = __ballot_sync(kFull, s1 >= thr[1]);
    const int warp_row = row0 - (lane >> 2);  // 16 * warp
    if (k <= kLaneK) {
      // each quad hands its lowest pending score of each of its two
      // queries to the lane that owns that query (lanes 4 * (lane / 4) +
      // h): the warp fills its sixteen lists at once
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
          const float cur = own ? c1 : c0;
          const int idx = key + 2 * ((own ? src1 : src0) & 3);
          if (cur > wsc || (cur == wsc && idx < wid)) {
            lane_replace(ls + ql * kp, li + ql * kp, k, cur, idx, wpos, wsc,
                         wid);
            if (share && wsc > kNegInf)
              atomicMax(bound + q0 + ql, order_key(wsc));
          }
          kth = fmaxf(wsc, own ? shr[1] : shr[0]);
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
          const int ql = warp_row + (src >> 2) + 8 * h;
          const float kth = warp_insert(ls + ql * kp, li + ql * kp, k, cur,
                                        key + 2 * (src & 3));
          if (share && lane == src && kth > kNegInf)
            atomicMax(bound + q0 + ql, order_key(kth));
          if ((lane >> 2) == (src >> 2)) thr[h] = fmaxf(kth, shr[h]);
        }
      }
    }
  }
};

// Issue key tile t (stage t % kS) of at most 128 columns against the
// resident query tile into d, as one wgmma group once the tile has
// landed: mma_tile's k16 steps, in its order.
template <int kS>
__device__ __forceinline__ void issue_tile(float (&d)[rgm::kAcc],
                                           const Ring& g, int t) {
  mbar_wait(g.full + 8 * (t % kS), (t / kS) & 1);
  rgm::fence_operand(d);
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
  const uint32_t b0 = g.at(t % kS);
  auto step = [&](int s) {
    wgmma_step(d, g.q + (s >> 2) * kBQ * 128 + (s & 3) * 32,
               b0 + (s >> 2) * kBR * 128 + (s & 3) * 32, s > 0);
  };
  // straight-line steps where the row is 64 or 128 columns wide
  const int steps = rgm::padded_width(g.e) / 16;
  if (steps == 4) {
#pragma unroll
    for (int s = 0; s < 4; ++s) step(s);
  } else if (steps == 8) {
#pragma unroll
    for (int s = 0; s < 8; ++s) step(s);
  } else {
    for (int s = 0; s < steps; ++s) step(s);
  }
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Consumers free stage s: one arrival a warp.
__device__ __forceinline__ void release(const Ring& g, int s, int lane) {
  if (lane == 0) mbar_arrive(g.empty + 8 * s);
}

// Registers a thread of each role keeps after setmaxnreg: two blocks an
// SM start at 128 a thread; the producer warpgroup gives up all but 24 and
// the consumer warpgroup takes them.
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 232;

// The consumer warpgroup (kBQ queries) and the producer warpgroup walk the
// block's range of keys, staged as kMode says. bound (Q,) and passes are
// zero before the launch.
template <int kMode>
__global__ void __launch_bounds__(kThreads, 2)
topk_partial_kernel(const __grid_constant__ CUtensorMap qmap,
                    const __grid_constant__ CUtensorMap kmap,
                    const uint8_t* __restrict__ valid,
                    float* __restrict__ part_s, int* __restrict__ part_i,
                    unsigned* __restrict__ bound,
                    unsigned long long* __restrict__ passes, int n_q,
                    int n_r, int e, int k, int splits, int rows_per_split) {
  constexpr bool kChunk = kMode == kChunked;
  constexpr int kS = ring_stages(kMode);
  constexpr int kConsumerWarps = 4;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = rgm::aligned_smem(smem_raw);

  Ring g;
  g.e = e;
  g.pieces = kChunk ? n_pieces(e) : 1;
  g.q = rgm::smem_addr(smem);
  g.first = g.q + (uint32_t)query_tile_bytes(kBQ, e);
  g.stage = (uint32_t)stage_bytes(kBQ, e);
  g.qpiece = kChunk ? (uint32_t)rgm::tile_bytes(kBQ, kPieceE) : 0;
  uint8_t* tail = smem + (g.first - g.q) + kS * g.stage;
  float* ls = reinterpret_cast<float*>(tail);
  const int kp = (k + 3) & ~3;  // a list's stride: 16-byte rows
  int* li = reinterpret_cast<int*>(ls + kBQ * kp);  // (BQ, kp) lists
  g.full = rgm::smem_addr(li + kBQ * kp);
  g.empty = g.full + 8 * kS;

  const int q0 = blockIdx.x * kBQ;
  const int split = blockIdx.y;
  const long long r_begin = (long long)split * rows_per_split;
  const long long r_end = min((long long)n_r, r_begin + rows_per_split);
  const int n_tiles = (int)((r_end - r_begin + kBR - 1) / kBR);
  // the warp's index, known to the compiler to be the same in all lanes
  const int warp = __shfl_sync(kFull, threadIdx.x / 32, 0);
  const int lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kS; ++s) {
      mbar_init(g.full + 8 * s, 1);
      mbar_init(g.empty + 8 * s, kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= kConsumerWarps) {
    // the producer: piece p = t * pieces + c is columns 128c.. of key tile
    // t (and, for wide rows, of the query tile) in stage p % kS, staged by
    // the first lane of the warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
        kProducerRegs));
    if (warp != kConsumerWarps || lane != 0) return;
    const int total = n_tiles * g.pieces;
    const int q_atoms = atoms(e);
    for (int p = 0; p < total; ++p) {
      const int s = p % kS;
      const int t = p / g.pieces;
      const int c = p - t * g.pieces;
      mbar_wait(g.empty + 8 * s, ((p / kS) & 1) ^ 1);
      const uint32_t bar = g.full + 8 * s, st = g.at(s);
      const int n_at = atoms(piece_w(e, c));
      uint32_t bytes = n_at * kBR * 128;
      if (kChunk) bytes += n_at * kBQ * 128;
      else if (p == 0) bytes += q_atoms * kBQ * 128;
      mbar_expect(bar, bytes);
      if (!kChunk && p == 0)
        for (int a = 0; a < q_atoms; ++a)
          tma_box(qmap, g.q + a * kBQ * 128, kBoxE * a, q0, bar);
      const int row = (int)(r_begin + (long long)t * kBR);
      for (int a = 0; a < n_at; ++a) {
        const int col = kPieceE * c + kBoxE * a;
        if (kChunk) tma_box(qmap, st + a * kBQ * 128, col, q0, bar);
        tma_box(kmap, st + g.qpiece + a * kBR * 128, col, row, bar);
      }
    }
    return;
  }

  // a consumer: warp w of the block filters query rows 16w .. 16w + 15
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
      kConsumerRegs));
  Filter f;
  f.ls = ls;
  f.li = li;
  f.bound = bound;
  f.valid = valid;
  f.r_begin = (int)r_begin;
  f.r_end = (int)r_end;
  f.n_tiles = n_tiles;
  f.k = k;
  f.kp = kp;
  f.wpos = 0;
  f.wid = 0;
  f.wsc = kNegInf;
  f.q0 = q0;
  f.lane = lane;
  f.row0 = 16 * warp + (lane >> 2);
  f.share = splits > 1;
  f.live_warp = q0 + 16 * warp < n_q;
  f.passes = 0;
  // this thread's two queries (accumulator rows h = 0, 1): the larger of
  // the list's k-th score and the shared bound, against which the scores
  // are filtered; a query past Q never passes the filter
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    f.live_q[h] = q0 + f.row0 + 8 * h < n_q;
    f.thr[h] = f.live_q[h] ? kNegInf : INFINITY;
    f.shr[h] = kNegInf;
    f.next_bound[h] = 0;
  }
  for (int t = lane; t < 16 * kp; t += 32) {
    ls[16 * warp * kp + t] = kNegInf;
    li[16 * warp * kp + t] = 0;
  }
  __syncwarp();
  f.flags(r_begin);

  if (!kChunk) {
    // tile t's scores land in acc, move to sc, and tile t + 1's product
    // goes into acc while the filter reads sc
    float acc[rgm::kAcc], sc[rgm::kAcc];
    if (n_tiles > 0) issue_tile<kS>(acc, g, 0);
    for (int t = 0; t < n_tiles; ++t) {
      wgmma_wait<0>();
      rgm::fence_operand(acc);
#pragma unroll
      for (int v = 0; v < rgm::kAcc; ++v) sc[v] = acc[v];
      release(g, t % kS, lane);
      if (t + 1 < n_tiles) issue_tile<kS>(acc, g, t + 1);
      f.tile(sc, t);
    }
  } else {
    float acc[rgm::kAcc];
    for (int t = 0; t < n_tiles; ++t) {
      for (int c = 0; c < g.pieces; ++c) {
        const int p = t * g.pieces + c;
        const uint32_t st = g.at(p % kS);
        mbar_wait(g.full + 8 * (p % kS), (p / kS) & 1);
        rgm::fence_operand(acc);
        asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
        const int steps = rgm::padded_width(piece_w(e, c)) / 16;
        for (int s = 0; s < steps; ++s)
          wgmma_step(acc, st + (s >> 2) * kBQ * 128 + (s & 3) * 32,
                     st + g.qpiece + (s >> 2) * kBR * 128 + (s & 3) * 32,
                     c > 0 || s > 0);
        asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
        if (c > 0) {
          wgmma_wait<1>();
          if (lane == 0) mbar_arrive(g.empty + 8 * ((p - 1) % kS));
        }
      }
      wgmma_wait<0>();
      rgm::fence_operand(acc);
      if (lane == 0)
        mbar_arrive(g.empty + 8 * ((t * g.pieces + g.pieces - 1) % kS));
      f.tile(acc, t);
    }
  }

  if (k <= kLaneK && (lane & 3) < 2) {
    const int ql = f.row0 + 8 * (lane & 3);
    sort_list(ls + ql * kp, li + ql * kp, k);
  }
  __syncwarp();
  for (int t = lane; t < 16 * k; t += 32) {
    const int ql = 16 * warp + t / k;
    const int i = t - (t / k) * k;
    if (q0 + ql < n_q) {
      const long long o = ((long long)(q0 + ql) * splits + split) * k + i;
      part_s[o] = ls[ql * kp + i];
      part_i[o] = li[ql * kp + i];
    }
  }
  if (lane == 0 && f.passes) atomicAdd(passes, (unsigned long long)f.passes);
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

// cuTensorMapEncodeTiled from libcuda, which the CUDA runtime has loaded
// (no link against libcuda).
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* h = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (h == nullptr) h = dlopen("libcuda.so.1", RTLD_NOW);
    return h ? reinterpret_cast<EncodeTiled>(
                   dlsym(h, "cuTensorMapEncodeTiled"))
             : nullptr;
  }();
  return fn;
}

// The TMA map of a row-major (rows, e) bf16 matrix in boxes of kBoxE
// columns and box_rows rows, 128-byte swizzled, zeros past its edges.
cudaError_t tensor_map(CUtensorMap* map, const void* ptr, int rows, int e,
                       int box_rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return cudaErrorSymbolNotFound;
  const cuuint64_t dims[2] = {(cuuint64_t)e, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)e * sizeof(__nv_bfloat16)};
  const cuuint32_t box[2] = {kBoxE, (cuuint32_t)box_rows};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                        const_cast<void*>(ptr), dims, strides, box, unit,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int kMode>
cudaError_t launch_partial(const dim3& grid, size_t smem, cudaStream_t s,
                           const CUtensorMap& qm, const CUtensorMap& km,
                           const uint8_t* valid, float* part_s, int* part_i,
                           unsigned* bound, unsigned long long* passes,
                           int n_q, int n_r, int e, int k, int splits,
                           int rows_per_split) {
  cudaError_t err = cudaFuncSetAttribute(
      topk_partial_kernel<kMode>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  topk_partial_kernel<kMode><<<grid, kThreads, smem, s>>>(
      qm, km, valid, part_s, part_i, bound, passes, n_q, n_r, e, k, splits,
      rows_per_split);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q (Q, E) and keys (R, E) bf16, row-major, 16-byte aligned, E % 8 == 0
// (rows wider than 256 in chunks of 128 columns); valid (R,) uint8 or null;
// 1 <= k <= 128 (a larger k takes the selection family, select_topk.cu);
// block_q 64 queries per block; 1 <= splits <= 32 ranges of
// rows_per_split keys (a multiple of 128). Scratch part_s / part_i hold
// (Q, splits, k); bound holds 8 + 4Q bytes, zeroed here by one memset: the
// count of warp-tiles whose vote passed (uint64), then the shared bound
// (Q uint32). out_s / out_i are (Q, k).
int rg_fused_cosine_topk(const void* q, const void* keys, const void* valid,
                         void* part_s, void* part_i, void* bound,
                         void* out_s, void* out_i, int n_q, int n_r, int e,
                         int k, int block_q, int splits, int rows_per_split,
                         void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_q == 0) return (int)cudaGetLastError();
  if (block_q != kBQ || splits < 1 || splits > 32 ||
      rows_per_split % kBR != 0 || k < 1 || k > 128)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((n_q + kBQ - 1) / kBQ, splits);
  CUtensorMap qm, km;
  cudaError_t err = tensor_map(&qm, q, n_q, e, block_q);
  if (err == cudaSuccess) err = tensor_map(&km, keys, n_r, e, kBR);
  if (err != cudaSuccess) return (int)err;
  const auto* vb = static_cast<const uint8_t*>(valid);
  auto* ps = static_cast<float*>(part_s);
  auto* pi = static_cast<int*>(part_i);
  auto* passes = static_cast<unsigned long long*>(bound);
  auto* bd = reinterpret_cast<unsigned*>(passes + 1);
  err = cudaMemsetAsync(bound, 0, sizeof(unsigned long long) +
                                      sizeof(unsigned) * (size_t)n_q, s);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = smem_bytes(e, k);
  switch (mode(e)) {
    case kNarrow:
      err = launch_partial<kNarrow>(grid, smem, s, qm, km, vb, ps, pi, bd,
                                    passes, n_q, n_r, e, k, splits,
                                    rows_per_split);
      break;
    case kResident:
      err = launch_partial<kResident>(grid, smem, s, qm, km, vb, ps, pi, bd,
                                      passes, n_q, n_r, e, k, splits,
                                      rows_per_split);
      break;
    default:
      err = launch_partial<kChunked>(grid, smem, s, qm, km, vb, ps, pi, bd,
                                     passes, n_q, n_r, e, k, splits,
                                     rows_per_split);
  }
  if (err != cudaSuccess) return (int)err;
  topk_merge_kernel<<<(n_q + kMergeWarps - 1) / kMergeWarps, kMergeThreads, 0,
                      s>>>(ps, pi, static_cast<float*>(out_s),
                           static_cast<int*>(out_i), n_q, splits, k);
  return (int)cudaGetLastError();
}

}  // extern "C"
