// Prefix sum over the rows of an (N, D) matrix (kernel H).
//
// Replaces _cumsum_kernel of ragraph_tpu/ops/pallas_segment.py (:75, called
// by _cumsum_call at :106, which streaming_cumsum, sorted_segment_sum_indptr
// and sorted_segment_sum reach): the inclusive or exclusive prefix over axis
// 0 of an f32 or bf16 matrix, accumulated and written in f32, plus the
// (1, D) grand total that the segment-sum consumer reads at the position
// past the end. The exclusive prefix is the running sum before the row is
// added, not the TPU's `inclusive - x`.
//
// What bounds it on an H100: bytes. One add per element against 4 (or 2)
// bytes in and 4 bytes out; the least traffic is the input read once and
// the output written once, N * D * (in bytes + 4) + 4 * D: 1.07 GB at
// 2^21 x 64 f32, 0.32 ms at 3.35 TB/s.
//
// The TPU kernel walks its row blocks in grid order and carries the running
// row in scratch memory, because its grid is sequential. Here blocks run in
// parallel, so the design reads the input once and passes the carry between
// tiles through device memory, in an order fixed by the shape alone:
//   * Tiles. A tile is kTileRows rows of one slab of at most kSlab columns;
//     the slabs of a row are independent scans, so D = 1 and D = 512 take
//     the same code. A block takes its tile id from an atomic counter, in
//     launch order, never from blockIdx: id = row tile * slabs + slab, so a
//     tile waits only on tiles whose blocks have already started, and the
//     grid may be far larger than the blocks resident at once.
//   * In a tile, a thread owns a run of 16 consecutive rows at four
//     columns: one 16-byte f32 or 8-byte bf16 load a row, and a 16-byte f32
//     store, where D is a multiple of 4 and the input is aligned; four
//     loads and stores of one column otherwise, masked past D. The layout,
//     and so the order of the adds, is the same either way: it depends on
//     the shape alone, not on the input's address. Four bf16 columns, not
//     eight: eight would make a thread's f32 row two 16-byte stores that
//     each fill half of the sectors they touch. A thread issues all of its
//     loads before it adds, then sums its run in row order; the run totals
//     scan through shared memory in run order, giving each run's offset
//     and the tile's aggregate A.
//   * The carry, in three levels. Tiles form groups of kGroup, groups form
//     supergroups of kSuper. A tile publishes its aggregate A; the last tile
//     of a group publishes the group's sum S = (its group's A, in order) as
//     soon as it has them, before it reads the S of earlier groups; the
//     last tile of a supergroup publishes the next supergroup's base,
//     C' = C + (the supergroup's S, in order). A tile's carry is
//     C + (S of the groups before it in its supergroup + A of the tiles
//     before it in its group), each list read by all threads at once and
//     added in an order that depends on the tile's place alone. Only C
//     chains, N / (kTileRows * kGroup * kSuper) links; an S waits on the A
//     of its group and an A on its own rows, neither on another S. Two
//     calls give the same bits, and no timing-dependent look-back decides
//     which partial sums are added.
//   * Publishing. A, S and C are one 64-bit word a column: the f32 value
//     with a tag in its high half, stored and polled whole at gpu scope
//     (st.relaxed.gpu / ld.relaxed.gpu; a 64-bit access is single-copy
//     atomic), so a reader that sees the tag sees the value: no flag, no
//     fence, one L2 round trip a hand-on. The counter and every tag are
//     zeroed by a memset on the stream before each launch, the only other
//     pass over the scratch: the scratch is the caller's, fresh each call,
//     so a generation number could match stale words by chance. The
//     scratch's size and layout are this file's alone
//     (rg_prefix_sum_scratch_words).
//
// Offsets are 64-bit. Rows past N and columns past D are masked.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSlab = 64;                    // columns of a tile
constexpr int kCols = 4;                     // columns of a thread
constexpr int kLanes = kSlab / kCols;        // threads across a slab row
constexpr int kRuns = kThreads / kLanes;     // runs of a tile
constexpr int kTileRows = 256;
constexpr int kRunRows = kTileRows / kRuns;  // rows of a run
constexpr int kGroup = 64;                   // tiles a group sum covers
constexpr int kSuper = 16;                   // groups a chained base covers
constexpr int kMinBlocks = 2;                // a run's 64 values in registers
constexpr unsigned long long kTag = 1ull << 32;
constexpr unsigned kMaxPolls = 1u << 26;     // seconds of polls
constexpr unsigned kPollNs = 32;
static_assert(kTileRows % kRuns == 0, "a run is whole rows");

// Four input columns at p into f32, streaming (the input is read once):
// one vector load where WIDE, else the `cols` columns that lie in the row
// one at a time, and 0 past them.
template <bool WIDE>
__device__ __forceinline__ void load_in(const float* p, int cols, float* v) {
  if constexpr (WIDE) {
    const float4 q = __ldcs(reinterpret_cast<const float4*>(p));
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  } else {
#pragma unroll
    for (int e = 0; e < kCols; ++e) v[e] = e < cols ? __ldcs(p + e) : 0.f;
  }
}

template <bool WIDE>
__device__ __forceinline__ void load_in(const __nv_bfloat16* p, int cols,
                                        float* v) {
  if constexpr (WIDE) {
    const uint2 q = __ldcs(reinterpret_cast<const uint2*>(p));
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&q);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  } else {
#pragma unroll
    for (int e = 0; e < kCols; ++e)
      v[e] = e < cols ? __bfloat162float(p[e]) : 0.f;
  }
}

// The `cols` f32 values of v that lie in the row to p, streaming (the
// output is written once); one 16-byte store where WIDE.
template <bool WIDE>
__device__ __forceinline__ void store_out(float* p, int cols, const float* v) {
  if constexpr (WIDE) {
    __stcs(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
  } else {
#pragma unroll
    for (int e = 0; e < kCols; ++e)
      if (e < cols) __stcs(p + e, v[e]);
  }
}

// Four tagged words at p (16-byte aligned), relaxed at gpu scope: each word
// is one f32 value with kTag or'ed into its high half.
__device__ __forceinline__ void publish(unsigned long long* p,
                                        const float* v) {
#pragma unroll
  for (int i = 0; i < kCols; i += 2)
    asm volatile("st.relaxed.gpu.global.v2.u64 [%0], {%1, %2};"
                 :: "l"(p + i), "l"(kTag | __float_as_uint(v[i])),
                    "l"(kTag | __float_as_uint(v[i + 1])) : "memory");
}

// Reads the four tagged words at p into v; false if one is not yet tagged.
__device__ __forceinline__ bool read_tagged(const unsigned long long* p,
                                            float* v) {
  bool ok = true;
#pragma unroll
  for (int i = 0; i < kCols; i += 2) {
    unsigned long long a, b;
    asm volatile("ld.relaxed.gpu.global.v2.u64 {%0, %1}, [%2];"
                 : "=l"(a), "=l"(b) : "l"(p + i) : "memory");
    v[i] = __uint_as_float((unsigned)a);
    v[i + 1] = __uint_as_float((unsigned)b);
    ok = ok && a >= kTag && b >= kTag;
  }
  return ok;
}

// Spins until the four words at p are tagged; a wait of kMaxPolls polls is
// a fault of the chain and traps, so that it fails the call instead of
// holding the card.
__device__ __forceinline__ void wait_tagged(const unsigned long long* p,
                                            float* v) {
  for (unsigned polls = 0; !read_tagged(p, v); ++polls) {
    if (polls == kMaxPolls) __trap();
    __nanosleep(kPollNs);
  }
}

// Adds the n_items tagged vectors at p, p + stride, ... (waiting for
// each), thread (run, lane) taking items run, run + kRuns, ... in order;
// `part` gets each run's partial sum, and the return is their sum in run
// order: an order fixed by n_items.
template <int kPer>
__device__ __forceinline__ void sum_tagged(const unsigned long long* p,
                                           long long stride, int n_items,
                                           int run, int lane,
                                           float (*part)[kSlab], float* out) {
  float a[kPer][kCols];
  bool ready[kPer];
#pragma unroll
  for (int q = 0; q < kPer; ++q) {
    const int idx = run + q * kRuns;
    ready[q] = true;
    if (idx < n_items) {
      ready[q] = read_tagged(p + idx * stride, a[q]);
    } else {
#pragma unroll
      for (int e = 0; e < kCols; ++e) a[q][e] = 0.f;
    }
  }
#pragma unroll
  for (int q = 0; q < kPer; ++q)
    if (!ready[q]) wait_tagged(p + (run + q * kRuns) * stride, a[q]);
#pragma unroll
  for (int q = 1; q < kPer; ++q)
#pragma unroll
    for (int e = 0; e < kCols; ++e) a[0][e] += a[q][e];
#pragma unroll
  for (int e = 0; e < kCols; ++e) part[run][lane * kCols + e] = a[0][e];
  __syncthreads();
#pragma unroll
  for (int e = 0; e < kCols; ++e) out[e] = part[0][lane * kCols + e];
#pragma unroll 4
  for (int k = 1; k < kRuns; ++k)
#pragma unroll
    for (int e = 0; e < kCols; ++e) out[e] += part[k][lane * kCols + e];
}

// Kernel H's tiles and the layout of its scratch, in 32-bit words: the
// tile counter (padded to 16 bytes), then from `chain` the supergroup
// bases, from `sums` the group sums and from `aggs` the tile aggregates,
// a row of one tagged 64-bit word a column each; `words` in all.
struct Plan {
  int slabs;
  long long row_tiles, chain, sums, aggs, words;
};

Plan plan_of(long long n, int d) {
  Plan p;
  p.slabs = (d + kSlab - 1) / kSlab;
  p.row_tiles = (n + kTileRows - 1) / kTileRows;
  const long long groups = (p.row_tiles + kGroup - 1) / kGroup;
  const long long supers = (groups + kSuper - 1) / kSuper;
  const long long row = 2LL * p.slabs * kSlab;
  p.chain = 4;
  p.sums = p.chain + supers * row;
  p.aggs = p.sums + groups * row;
  p.words = p.aggs + p.row_tiles * row;
  return p;
}

// One block a tile, of the grid's row_tiles x slabs; `chain`, `sums` and
// `aggs` are the scratch's levels (Plan), all zeroed before the launch.
template <typename T, bool WIDE, bool EXCLUSIVE>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
scan_kernel(const T* __restrict__ x, float* __restrict__ out,
            float* __restrict__ total, unsigned* counter,
            unsigned long long* chain, unsigned long long* sums,
            unsigned long long* aggs, long long n, int d, int n_slabs,
            long long n_row_tiles) {
  __shared__ unsigned s_tile;
  __shared__ __align__(16) float s_run[kRuns][kSlab];
  __shared__ __align__(16) float s_part_a[kRuns][kSlab];
  __shared__ __align__(16) float s_part_s[kRuns][kSlab];

  const int tid = threadIdx.x;
  const int lane = tid % kLanes;
  const int run = tid / kLanes;
  if (tid == 0) s_tile = atomicAdd(counter, 1u);
  __syncthreads();
  const long long t = s_tile;
  const long long rt = t / n_slabs;
  const int slab = (int)(t - rt * n_slabs);
  const int col = slab * kSlab + lane * kCols;
  const int cols = min(kCols, d - col);   // this thread's columns in the row
  const long long row0 = rt * kTileRows + (long long)run * kRunRows;
  const long long words = (long long)n_slabs * kSlab;   // a level's row

  // the run's rows, every load in flight before the first add
  float v[kRunRows][kCols];
#pragma unroll
  for (int k = 0; k < kRunRows; ++k) {
    if (cols > 0 && row0 + k < n) {
      load_in<WIDE>(x + (row0 + k) * d + col, cols, v[k]);
    } else {
#pragma unroll
      for (int e = 0; e < kCols; ++e) v[k][e] = 0.f;
    }
  }
  float s[kCols];
#pragma unroll
  for (int e = 0; e < kCols; ++e) s[e] = v[0][e];
#pragma unroll
  for (int k = 1; k < kRunRows; ++k)
#pragma unroll
    for (int e = 0; e < kCols; ++e) s[e] += v[k][e];
#pragma unroll
  for (int e = 0; e < kCols; ++e) s_run[run][lane * kCols + e] = s[e];
  __syncthreads();

  // the run's offset in the tile: the run totals before it, in run order
  float o[kCols];
#pragma unroll
  for (int e = 0; e < kCols; ++e) o[e] = 0.f;
  for (int k = 0; k < run; ++k)
#pragma unroll
    for (int e = 0; e < kCols; ++e) o[e] += s_run[k][lane * kCols + e];

  // where the tile stands: group g (place j), supergroup h (place jj)
  const long long g = rt / kGroup;
  const int j = (int)(rt - g * kGroup);
  const long long h = g / kSuper;
  const int jj = (int)(g - h * kSuper);
  const bool more = rt + 1 < n_row_tiles;
  const long long at = (long long)slab * kSlab + lane * kCols;

  float agg[kCols];
  const bool last_run = run == kRuns - 1;
  if (last_run) {
#pragma unroll
    for (int e = 0; e < kCols; ++e) agg[e] = o[e] + s[e];
    if (more && j < kGroup - 1) publish(aggs + rt * words + at, agg);
  }

  // A of the tiles before this one in its group; the group's last tile
  // publishes S at once, then S of the groups before it in its supergroup
  float a_sum[kCols], s_sum[kCols], group_sum[kCols];
  sum_tagged<(kGroup + kRuns - 1) / kRuns>(
      aggs + (rt - j) * words + at, words, j, run, lane, s_part_a, a_sum);
  if (last_run && j == kGroup - 1) {
#pragma unroll
    for (int e = 0; e < kCols; ++e) group_sum[e] = a_sum[e] + agg[e];
    if (more && jj < kSuper - 1) publish(sums + g * words + at, group_sum);
  }
  sum_tagged<(kSuper + kRuns - 1) / kRuns>(
      sums + (g - jj) * words + at, words, jj, run, lane, s_part_s, s_sum);

  // the supergroup's base; its last tile hands the next one's on at once
  float base[kCols];
  if (h > 0) {
    wait_tagged(chain + h * words + at, base);
  } else {
#pragma unroll
    for (int e = 0; e < kCols; ++e) base[e] = 0.f;
  }
  if (last_run && j == kGroup - 1 && jj == kSuper - 1 && more) {
    float nb[kCols];
#pragma unroll
    for (int e = 0; e < kCols; ++e)
      nb[e] = base[e] + (s_sum[e] + group_sum[e]);
    publish(chain + (h + 1) * words + at, nb);
  }
  float carry[kCols];
#pragma unroll
  for (int e = 0; e < kCols; ++e) carry[e] = base[e] + (s_sum[e] + a_sum[e]);
  if (last_run && !more) {
#pragma unroll
    for (int e = 0; e < kCols; ++e)
      if (e < cols) total[col + e] = carry[e] + agg[e];
  }

  // the rows: the running sum from the carry and the run's offset
  float acc[kCols];
#pragma unroll
  for (int e = 0; e < kCols; ++e) acc[e] = carry[e] + o[e];
#pragma unroll
  for (int k = 0; k < kRunRows; ++k) {
    const bool ok = cols > 0 && row0 + k < n;
    if (EXCLUSIVE) {
      if (ok) store_out<WIDE>(out + (row0 + k) * d + col, cols, acc);
#pragma unroll
      for (int e = 0; e < kCols; ++e) acc[e] += v[k][e];
    } else {
#pragma unroll
      for (int e = 0; e < kCols; ++e) acc[e] += v[k][e];
      if (ok) store_out<WIDE>(out + (row0 + k) * d + col, cols, acc);
    }
  }
}

template <typename T, bool WIDE>
cudaError_t launch_wide(const T* x, float* out, float* total, unsigned* w,
                        const Plan& p, long long n, int d, bool exclusive,
                        cudaStream_t stream) {
  auto* chain = reinterpret_cast<unsigned long long*>(w + p.chain);
  auto* sums = reinterpret_cast<unsigned long long*>(w + p.sums);
  auto* aggs = reinterpret_cast<unsigned long long*>(w + p.aggs);
  const unsigned grid = (unsigned)(p.row_tiles * p.slabs);
  if (exclusive)
    scan_kernel<T, WIDE, true><<<grid, kThreads, 0, stream>>>(
        x, out, total, w, chain, sums, aggs, n, d, p.slabs, p.row_tiles);
  else
    scan_kernel<T, WIDE, false><<<grid, kThreads, 0, stream>>>(
        x, out, total, w, chain, sums, aggs, n, d, p.slabs, p.row_tiles);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const T* x, float* out, float* total, void* scratch,
                   long long n, int d, bool exclusive, cudaStream_t stream) {
  const Plan p = plan_of(n, d);
  // the scratch reset: the counter and every tag
  cudaError_t err = cudaMemsetAsync(scratch, 0, (size_t)p.words * 4, stream);
  if (err != cudaSuccess) return err;
  unsigned* w = static_cast<unsigned*>(scratch);
  const bool wide = d % kCols == 0
      && (reinterpret_cast<uintptr_t>(x) & (kCols * sizeof(T) - 1)) == 0
      && (reinterpret_cast<uintptr_t>(out) & 15) == 0;
  if (wide)
    return launch_wide<T, true>(x, out, total, w, p, n, d, exclusive, stream);
  return launch_wide<T, false>(x, out, total, w, p, n, d, exclusive, stream);
}

}  // namespace

extern "C" {

// 32-bit words of rg_prefix_sum's scratch for an (n, d) input; -1 where
// n < 1, d < 1 or the tiles exceed a grid's 2^31 - 1 blocks.
long long rg_prefix_sum_scratch_words(long long n, int d) {
  if (n < 1 || d < 1) return -1;
  const Plan p = plan_of(n, d);
  if (p.row_tiles * p.slabs >= (1LL << 31)) return -1;
  return p.words;
}

// Kernel H. `x` is (n, d) f32, or bf16 when `bf16_in` is set; n >= 1,
// d >= 1. `out` is (n, d) f32, `total` (1, d) f32. `scratch` holds
// rg_prefix_sum_scratch_words(n, d) 32-bit words, 16-byte aligned; the
// call zeroes it.
int rg_prefix_sum(const void* x, void* out, void* total, void* scratch,
                  long long n, int d, int exclusive, int bf16_in,
                  void* stream) {
  if (rg_prefix_sum_scratch_words(n, d) < 0
      || (reinterpret_cast<uintptr_t>(scratch) & 15))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  float* t = static_cast<float*>(total);
  if (bf16_in)
    return (int)launch(static_cast<const __nv_bfloat16*>(x), o, t, scratch, n,
                       d, exclusive != 0, s);
  return (int)launch(static_cast<const float*>(x), o, t, scratch, n, d,
                     exclusive != 0, s);
}

}  // extern "C"
