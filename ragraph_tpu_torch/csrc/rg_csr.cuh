// The CSR row walk of kernels A (csr_segment.cu) and K (probes.cu):
//
//   out[r] = sum_{e in [indptr[r], indptr[r+1])} message(e),  f32 sums,
//
// message(e) = w[e] * table[idx[e]] (A, TableRows) or
// w_lo[e] * T[idx[e], :d] + w_hi[e] * T[idx[e], d:] (K, PackedRows).
//
// One order of sums. Every edge is one fmaf a column into one accumulator,
// in edge order (K: the low half's, then the high half's); the partial sums
// of a long row's pieces add in piece order. With w_lo = w (1 - parity),
// w_hi = w parity over idx >> 1, K is therefore A to the bit (a zero weight
// adds +0), and two calls on the same inputs give the same bits: no
// floating-point atomics anywhere.
//
// Lane groups. A group of G lanes sums one output row at a time. A row is
// cut into chunks of one load each: 16 bytes (8 bf16 or 4 f32 columns) when the row's
// bytes are a multiple of 16, else a pair of columns (4 or 8 bytes), else
// (an odd width) one column. G is the
// least power of two >= the number of chunks, at most 32; lane l of the group
// owns chunks l, l + G, ... (A's 64-wide bf16 row: 8 lanes, 4 groups a warp).
// A row of more chunks than a source's kMaxChunks (512 columns, 256 of one
// column a chunk) is walked in column slices of that many chunks, each by
// launches of its own (launch_walk); a column's sum is the same in a slice
// as in a whole row.
//
// Latency. The gathers read rows from L2 (A's 33.5 MB bf16 table fits its 50
// MB), so the walk keeps loads in flight rather than saving bytes; on the
// card its pace follows the number of resident warps more than the bytes in
// flight a lane (PERF.md). A group walks kRows consecutive short rows as one
// stream of batches of kBatch edges: its lanes load a batch's ids and
// weights as one vector (streaming loads, so they do not push table rows out
// of L2), the next batch's ids (at a row's end, the next row's first) are
// loaded before this batch's rows, and each lane issues kFlyLoads row loads
// before it adds them. So a row costs about one round trip to L2, where one
// group a row paid three (indptr, then ids, then rows).
//
// Hubs. A row of more than hub_edges edges is cut into pieces of hub_edges
// edges by a plan made from indptr alone (ops/csr_segment.py::walk_plan).
// A first launch walks every piece with a group of its own and writes the
// piece's partial sum; the row launch sums each long row's partials in piece
// order, and gives the long rows the first groups so that their sums run
// beside the short rows instead of after them. A graph with no long row takes
// the row launch alone.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace rgc {

constexpr int kThreads = 256;  // a block holds 256 / G groups
constexpr int kBatch = 8;      // edges whose ids a group loads at a time
constexpr int kRows = 8;       // short rows a group walks, one after another
constexpr int kFlyLoads = 4;   // row loads a lane issues before it adds

// Blocks an SM must hold: four (50% occupancy, at most 64 registers a
// thread) for a lane that owns one chunk; latency, not bytes in flight a
// lane, sets the walk's pace (5 blocks or more spill registers).
template <int CH>
constexpr int kMinBlocks = CH == 1 ? 4 : 2;

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// 32-bit words of a load of VB bytes (one for 2 bytes).
template <int VB>
constexpr int kWordsOf = (VB + 3) / 4;

// VB bytes at p, as 32-bit words, through the read-only path (2 bytes in
// the low half of a word).
template <int VB>
__device__ __forceinline__ void load_words(const char* p,
                                           uint32_t (&w)[kWordsOf<VB>]) {
  if constexpr (VB == 16) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
    w[0] = v.x;
    w[1] = v.y;
    w[2] = v.z;
    w[3] = v.w;
  } else if constexpr (VB == 8) {
    const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
    w[0] = v.x;
    w[1] = v.y;
  } else if constexpr (VB == 4) {
    w[0] = __ldg(reinterpret_cast<const unsigned int*>(p));
  } else {
    w[0] = __ldg(reinterpret_cast<const unsigned short*>(p));
  }
}

// The columns of W words of T (bf16: the low half is the first column; one
// bf16 column alone sits in the low half).
template <typename T, int W, int N>
__device__ __forceinline__ void unpack(const uint32_t (&w)[W],
                                       float (&v)[N]) {
  static_assert(N == W * 4 / (int)sizeof(T) || (N == 1 && W == 1),
                "columns of W words");
  if constexpr (sizeof(T) == 2 && N == 1) {
    v[0] = __uint_as_float(w[0] << 16);
  } else {
#pragma unroll
    for (int i = 0; i < W; ++i) {
      if constexpr (sizeof(T) == 2) {
        v[2 * i] = __uint_as_float(w[i] << 16);
        v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
      } else {
        v[i] = __uint_as_float(w[i]);
      }
    }
  }
}

// N f32 columns at p (16-byte aligned when N % 4 == 0, else 8-byte, or
// one column).
template <int N>
__device__ __forceinline__ void load_f32(const float* p, float (&v)[N]) {
  if constexpr (N == 1) {
    v[0] = __ldg(p);
  } else if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N / 4; ++i) {
      const float4 x = __ldg(reinterpret_cast<const float4*>(p) + i);
      v[4 * i] = x.x;
      v[4 * i + 1] = x.y;
      v[4 * i + 2] = x.z;
      v[4 * i + 3] = x.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < N / 2; ++i) {
      const float2 x = __ldg(reinterpret_cast<const float2*>(p) + i);
      v[2 * i] = x.x;
      v[2 * i + 1] = x.y;
    }
  }
}

// Stores N f32 columns at p; `stream` marks them evict-first in L2 (the
// output, which is not read again by this call, should not push out rows).
template <int N>
__device__ __forceinline__ void store_f32(float* p, const float (&v)[N],
                                          bool stream) {
  if constexpr (N == 1) {
    if (stream)
      __stcs(p, v[0]);
    else
      *p = v[0];
  } else if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N / 4; ++i) {
      const float4 x = make_float4(v[4 * i], v[4 * i + 1], v[4 * i + 2],
                                   v[4 * i + 3]);
      float4* q = reinterpret_cast<float4*>(p) + i;
      if (stream)
        __stcs(q, x);
      else
        *q = x;
    }
  } else {
#pragma unroll
    for (int i = 0; i < N / 2; ++i) {
      const float2 x = make_float2(v[2 * i], v[2 * i + 1]);
      float2* q = reinterpret_cast<float2*>(p) + i;
      if (stream)
        __stcs(q, x);
      else
        *q = x;
    }
  }
}

// ---- the two message sources -------------------------------------------------

// Kernel A: w[e] * table[idx[e]], table rows of d elements of T; w rounded to
// bf16 when round_w. A chunk is VB bytes: 16, a pair of columns, or one.
template <typename T, int VB>
struct TableRows {
  static constexpr int kVB = VB;
  static constexpr int kWords = kWordsOf<VB>;       // per load
  static constexpr int kEl = VB / (int)sizeof(T);   // columns of a chunk
  static constexpr int kLoads = 1;                  // loads an edge and chunk
  // a slice: 512 columns, or 256 of one column a chunk
  static constexpr int kMaxChunks =
      kEl == 1 ? 256 : 512 * (int)sizeof(T) / VB;
  struct Edge {
    int s;
    float w;
  };

  const char* table;
  long long row_bytes;
  const int* idx;
  const float* w;
  bool round_w;

  __device__ __forceinline__ Edge edge(int e) const {
    const float x = __ldcs(w + e);
    return Edge{__ldcs(idx + e), round_w ? round_bf16(x) : x};
  }
  static __device__ __forceinline__ Edge shfl(unsigned mask, const Edge& x,
                                              int src, int width) {
    return Edge{__shfl_sync(mask, x.s, src, width),
                __shfl_sync(mask, x.w, src, width)};
  }
  __device__ __forceinline__ void load(const Edge& x, int q,
                                       uint32_t (&r)[kLoads][kWords]) const {
    load_words<VB>(table + x.s * row_bytes + q * VB, r[0]);
  }
  __device__ __forceinline__ void fma(const Edge& x,
                                      const uint32_t (&r)[kLoads][kWords],
                                      float (&acc)[kEl]) const {
    float v[kEl];
    unpack<T>(r[0], v);
#pragma unroll
    for (int i = 0; i < kEl; ++i) acc[i] = fmaf(x.w, v[i], acc[i]);
  }
};

// Kernel K: w_lo[e] * T[idx[e], :d] + w_hi[e] * T[idx[e], d:] from a bf16
// table packed two rows to one (packed row m = [row 2m | row 2m + 1]), both
// weights rounded to bf16. A chunk is loaded from each half.
template <int VB>
struct PackedRows {
  static constexpr int kVB = VB;
  static constexpr int kWords = VB / 4;
  static constexpr int kEl = VB / 2;
  static constexpr int kLoads = 2;
  static constexpr int kMaxChunks = 128 * 2 / VB;  // d <= 128
  struct Edge {
    int s;
    float lo, hi;
  };

  const char* table;
  long long row_bytes;   // 4 d: a packed row
  long long half_bytes;  // 2 d: where the high half starts
  const int* idx;
  const float* w_lo;
  const float* w_hi;

  __device__ __forceinline__ Edge edge(int e) const {
    return Edge{__ldcs(idx + e), round_bf16(__ldcs(w_lo + e)),
                round_bf16(__ldcs(w_hi + e))};
  }
  static __device__ __forceinline__ Edge shfl(unsigned mask, const Edge& x,
                                              int src, int width) {
    return Edge{__shfl_sync(mask, x.s, src, width),
                __shfl_sync(mask, x.lo, src, width),
                __shfl_sync(mask, x.hi, src, width)};
  }
  __device__ __forceinline__ void load(const Edge& x, int q,
                                       uint32_t (&r)[kLoads][kWords]) const {
    const char* p = table + x.s * row_bytes + q * VB;
    load_words<VB>(p, r[0]);
    load_words<VB>(p + half_bytes, r[1]);
  }
  __device__ __forceinline__ void fma(const Edge& x,
                                      const uint32_t (&r)[kLoads][kWords],
                                      float (&acc)[kEl]) const {
    float lo[kEl], hi[kEl];
    unpack<__nv_bfloat16>(r[0], lo);
    unpack<__nv_bfloat16>(r[1], hi);
#pragma unroll
    for (int i = 0; i < kEl; ++i) {
      acc[i] = fmaf(x.lo, lo[i], acc[i]);
      acc[i] = fmaf(x.hi, hi[i], acc[i]);
    }
  }
};

// ---- the walk ----------------------------------------------------------------

// Edges of a batch a lane holds.
template <int G>
constexpr int kPer = G < kBatch ? kBatch / G : 1;

// The lanes of this thread's group of G, aligned within the warp.
template <int G>
__device__ __forceinline__ unsigned group_mask() {
  if constexpr (G == 32)
    return 0xffffffffu;
  else
    return ((1u << G) - 1u) << ((threadIdx.x & 31) & ~(G - 1));
}

// Edges [base, base + kBatch) below end, edge j of the batch in slot j / G
// of lane j % G (an empty Edge past end).
template <class Src, int G>
__device__ __forceinline__ void fetch(const Src& src, int base, int end,
                                      int gl,
                                      typename Src::Edge (&b)[kPer<G>]) {
#pragma unroll
  for (int p = 0; p < kPer<G>; ++p) {
    const int j = gl + G * p;
    b[p] = j < kBatch && base + j < end ? src.edge(base + j)
                                        : typename Src::Edge{};
  }
}

// acc += the messages of the batch's first cnt edges, in edge order. Lane
// gl of the group owns chunks gl + G c (c < CH) of the row's n_chunks.
template <class Src, int G, int CH>
__device__ __forceinline__ void add_batch(const Src& src,
                                          const typename Src::Edge (&cur)[kPer<G>],
                                          int cnt, int gl, unsigned mask,
                                          int n_chunks,
                                          float (&acc)[CH][Src::kEl]) {
  using Edge = typename Src::Edge;
  // edges whose row loads a lane issues before it multiplies
  constexpr int kFly =
      CH * Src::kLoads >= kFlyLoads ? 1 : kFlyLoads / (CH * Src::kLoads);
#pragma unroll
  for (int j0 = 0; j0 < kBatch; j0 += kFly) {
    if (j0 >= cnt) break;
    Edge eb[kFly];
#pragma unroll
    for (int u = 0; u < kFly; ++u)
      eb[u] = Src::shfl(mask, cur[(j0 + u) / G], (j0 + u) % G, G);
    uint32_t raw[kFly][CH][Src::kLoads][Src::kWords];
#pragma unroll
    for (int u = 0; u < kFly; ++u) {
#pragma unroll
      for (int c = 0; c < CH; ++c) {
        if (j0 + u < cnt && gl + G * c < n_chunks)
          src.load(eb[u], gl + G * c, raw[u][c]);
      }
    }
#pragma unroll
    for (int u = 0; u < kFly; ++u) {
#pragma unroll
      for (int c = 0; c < CH; ++c) {
        if (j0 + u < cnt && gl + G * c < n_chunks)
          src.fma(eb[u], raw[u][c], acc[c]);
      }
    }
  }
}

template <int CH, int EL>
__device__ __forceinline__ void zero(float (&acc)[CH][EL]) {
#pragma unroll
  for (int c = 0; c < CH; ++c) {
#pragma unroll
    for (int i = 0; i < EL; ++i) acc[c][i] = 0.f;
  }
}

template <int G, int CH, int EL>
__device__ __forceinline__ void store_row(float* dst, int gl, int n_chunks,
                                          const float (&acc)[CH][EL],
                                          bool stream) {
#pragma unroll
  for (int c = 0; c < CH; ++c) {
    if (gl + G * c < n_chunks)
      store_f32<EL>(dst + (gl + G * c) * EL, acc[c], stream);
  }
}

// acc = the messages of edges [begin, end) (a piece of a long row), in
// edge order, the next batch's ids loaded before this batch's rows.
template <class Src, int G, int CH>
__device__ __forceinline__ void walk(const Src& src, int begin, int end,
                                     int gl, unsigned mask, int n_chunks,
                                     float (&acc)[CH][Src::kEl]) {
  using Edge = typename Src::Edge;
  Edge cur[kPer<G>], nxt[kPer<G>];
  fetch<Src, G>(src, begin, end, gl, cur);
  for (int base = begin; base < end; base += kBatch) {
    if (base + kBatch < end) fetch<Src, G>(src, base + kBatch, end, gl, nxt);
    add_batch<Src, G, CH>(src, cur, min(kBatch, end - base), gl, mask,
                          n_chunks, acc);
#pragma unroll
    for (int p = 0; p < kPer<G>; ++p) cur[p] = nxt[p];
  }
}

// Rows [r0, r1) but the long ones, one after another into out: the batches
// of all the rows form one stream, and the next batch's ids (the next row's
// first, at a row's end) are loaded before this batch's rows. An empty row
// is a batch of no edges, written as a zero row.
template <class Src, int G, int CH>
__device__ __forceinline__ void walk_rows(const Src& src,
                                          const int* __restrict__ indptr,
                                          long long r0, long long r1,
                                          int hub_edges, float* out, int d,
                                          int gl, unsigned mask,
                                          int n_chunks) {
  using Edge = typename Src::Edge;
  // the first short row at or after r, its edges [b, e)
  auto next_short = [&](long long r, int& b, int& e) {
    for (; r < r1; ++r) {
      b = __ldg(indptr + r);
      e = __ldg(indptr + r + 1);
      if (e - b <= hub_edges) break;
    }
    return r;
  };
  int base, end;
  long long row = next_short(r0, base, end);
  if (row >= r1) return;
  float acc[CH][Src::kEl];
  zero(acc);
  Edge cur[kPer<G>], nxt[kPer<G>];
  fetch<Src, G>(src, base, end, gl, cur);
  while (true) {
    const int cnt = min(kBatch, end - base);
    long long next = row;
    int nbase = base + kBatch, nend = end;
    if (nbase >= end) next = next_short(row + 1, nbase, nend);
    if (next < r1) fetch<Src, G>(src, nbase, nend, gl, nxt);
    add_batch<Src, G, CH>(src, cur, cnt, gl, mask, n_chunks, acc);
    if (next != row) {
      store_row<G>(out + row * d, gl, n_chunks, acc, true);
      zero(acc);
      if (next >= r1) return;
    }
    row = next;
    base = nbase;
    end = nend;
#pragma unroll
    for (int p = 0; p < kPer<G>; ++p) cur[p] = nxt[p];
  }
}

// acc += partial rows [p0, p1) of an (n, d) f32 array, in order.
template <int EL, int G, int CH>
__device__ __forceinline__ void combine(const float* partial, int p0, int p1,
                                        int d, int gl, int n_chunks,
                                        float (&acc)[CH][EL]) {
  constexpr int kFly = CH >= 4 ? 1 : 4 / CH;  // partial rows in flight
  for (int p = p0; p < p1; p += kFly) {
    float v[kFly][CH][EL];
#pragma unroll
    for (int u = 0; u < kFly; ++u) {
#pragma unroll
      for (int c = 0; c < CH; ++c) {
        if (p + u < p1 && gl + G * c < n_chunks)
          load_f32<EL>(partial + (long long)(p + u) * d + (gl + G * c) * EL,
                       v[u][c]);
      }
    }
#pragma unroll
    for (int u = 0; u < kFly; ++u) {
#pragma unroll
      for (int c = 0; c < CH; ++c) {
        if (p + u < p1 && gl + G * c < n_chunks) {
#pragma unroll
          for (int i = 0; i < EL; ++i) acc[c][i] += v[u][c][i];
        }
      }
    }
  }
}

// The walk plan of one indptr (ops/csr_segment.py::walk_plan): the rows of
// more than hub_edges edges, piece_ptr[i]..piece_ptr[i+1] the pieces of
// long row i, pieces[p] = [begin, end) edges, partial (n_pieces, d) f32.
struct Plan {
  int hub_edges;
  const int* long_rows;
  const int* piece_ptr;
  long long n_long;
  const int2* pieces;
  long long n_pieces;
  float* partial;
};

// piece_pass: group g walks piece g into partial[g]. Else groups [0, n_long)
// sum the long rows' partials in order, and group n_long + i walks the short
// rows of [kRows i, kRows (i + 1)).
template <class Src, int G, int CH>
__global__ void __launch_bounds__(kThreads, kMinBlocks<CH>)
walk_kernel(const Src src, const int* __restrict__ indptr,
            float* __restrict__ out, long long n_rows, int d, int n_chunks,
            const Plan plan, bool piece_pass) {
  constexpr int EL = Src::kEl;
  const long long g = ((long long)blockIdx.x * kThreads + threadIdx.x) / G;
  const int gl = threadIdx.x % G;
  const unsigned mask = group_mask<G>();
  if (!piece_pass && g >= plan.n_long) {
    const long long r0 = (g - plan.n_long) * kRows;
    if (r0 < n_rows)
      walk_rows<Src, G, CH>(src, indptr, r0, min(r0 + kRows, n_rows),
                            plan.hub_edges, out, d, gl, mask, n_chunks);
    return;
  }
  float acc[CH][EL];
  zero(acc);
  if (piece_pass) {
    if (g >= plan.n_pieces) return;
    const int2 pc = plan.pieces[g];
    walk<Src, G, CH>(src, pc.x, pc.y, gl, mask, n_chunks, acc);
    store_row<G>(plan.partial + g * d, gl, n_chunks, acc, false);
  } else {
    combine<EL, G, CH>(plan.partial, plan.piece_ptr[g], plan.piece_ptr[g + 1],
                       d, gl, n_chunks, acc);
    store_row<G>(out + (long long)plan.long_rows[g] * d, gl, n_chunks, acc,
                 true);
  }
}

template <class Src, int G, int CH>
cudaError_t run(const Src& src, const int* indptr, float* out,
                long long n_rows, int d, int n_chunks, const Plan& plan,
                cudaStream_t stream) {
  constexpr long long kGroups = kThreads / G;  // a block's
  if (plan.n_pieces > 0) {
    walk_kernel<Src, G, CH>
        <<<(unsigned)((plan.n_pieces + kGroups - 1) / kGroups), kThreads, 0,
           stream>>>(src, indptr, out, n_rows, d, n_chunks, plan, true);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  const long long groups = plan.n_long + (n_rows + kRows - 1) / kRows;
  if (groups > 0)
    walk_kernel<Src, G, CH>
        <<<(unsigned)((groups + kGroups - 1) / kGroups), kThreads, 0,
           stream>>>(src, indptr, out, n_rows, d, n_chunks, plan, false);
  return cudaGetLastError();
}

// Both launches for rows of n_chunks chunks (at most Src::kMaxChunks): the
// group width and the chunks a lane owns follow from it.
template <class Src>
cudaError_t launch_slice(const Src& src, const int* indptr, float* out,
                         long long n_rows, int d, int n_chunks,
                         const Plan& plan, cudaStream_t stream) {
#define RGC_RUN(G, CH) \
  return run<Src, G, CH>(src, indptr, out, n_rows, d, n_chunks, plan, stream)
  if (n_chunks <= 1) RGC_RUN(1, 1);
  if (n_chunks <= 2) RGC_RUN(2, 1);
  if (n_chunks <= 4) RGC_RUN(4, 1);
  if (n_chunks <= 8) RGC_RUN(8, 1);
  if (n_chunks <= 16) RGC_RUN(16, 1);
  if constexpr (Src::kMaxChunks > 16) {
    if (n_chunks <= 32) RGC_RUN(32, 1);
  }
  if constexpr (Src::kMaxChunks > 32) {
    if (n_chunks <= 64) RGC_RUN(32, 2);
  }
  if constexpr (Src::kMaxChunks > 64) {
    if (n_chunks <= 128) RGC_RUN(32, 4);
  }
  if constexpr (Src::kMaxChunks > 128) {
    if (n_chunks <= 256) RGC_RUN(32, 8);
  }
#undef RGC_RUN
  return cudaErrorInvalidValue;
}

// The walk of rows of n_chunks chunks, d columns (the row stride of out and
// of the plan's partial sums): one launch_slice for each column slice of
// Src::kMaxChunks chunks.
template <class Src>
cudaError_t launch_walk(const Src& src, const int* indptr, float* out,
                        long long n_rows, int d, int n_chunks,
                        const Plan& plan, cudaStream_t stream) {
  for (int c0 = 0; c0 < n_chunks; c0 += Src::kMaxChunks) {
    Src slice = src;
    slice.table += (long long)c0 * Src::kVB;
    Plan p = plan;
    p.partial += c0 * Src::kEl;
    const cudaError_t err = launch_slice(
        slice, indptr, out + c0 * Src::kEl, n_rows, d,
        n_chunks - c0 < Src::kMaxChunks ? n_chunks - c0 : Src::kMaxChunks, p,
        stream);
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// Plan from the entry points' arguments.
inline Plan make_plan(int hub_edges, const void* long_rows,
                      const void* piece_ptr, long long n_long,
                      const void* pieces, long long n_pieces, void* partial) {
  return Plan{hub_edges,
              static_cast<const int*>(long_rows),
              static_cast<const int*>(piece_ptr),
              n_long,
              static_cast<const int2*>(pieces),
              n_pieces,
              static_cast<float*>(partial)};
}

}  // namespace rgc
