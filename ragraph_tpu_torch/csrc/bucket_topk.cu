// The four kernels of the two-phase exact bucket top-k (kernels D, E, F, G).
//
// They replace the Pallas kernels of ragraph_tpu/ops/bucket_topk.py:
//   D  rg_bucket_max      _bucket_max_kernel  scores reduced to the maximum of
//                                             each 128-key bucket
//   E  rg_column_topk     _col_topk_kernel    per-column top-k of (R, Q)
//   F  rg_bucket_rescore  _rescore_kernel     exact scores of each bucket's
//                                             assigned queries
//   G  rg_row_topk        _row_topk_kernel    per-row top-k of (Q, W)
// The glue between them (pair inversion, the overflow rounds of F, index
// math) is PyTorch code in ragraph_tpu_torch/ops/bucket_topk.py.
//
// Exactness across the phases needs D's maxima to be the very values F
// returns. Both take their scores from rg_mma.cuh's tensor-core tile with
// the query on the A side and the bucket's 128 keys as the B tile, over the
// same k16 steps, so a (query, key) pair sums its exact bf16 products in
// the same order in both, wherever the query sits in its tile. The plain
// versions add the products in sequence and differ from that order by a
// few f32 roundings.
//
// What bounds each on an H100, at Q = 2,048 queries, R = 262,144 keys,
// E = 64, k = 10:
//   D  operations: 2*Q*R*E = 68.7 GFLOP (0.07 ms at the bf16 tensor-core
//      rate) against 34 MB of input and a 16.8 MB result. Kernel C's tile
//      without its top-k: a block keeps 64 or 128 queries resident (one
//      warpgroup per 64) and walks a range of buckets, the next bucket's
//      keys in flight (cp.async) while the current one multiplies, one
//      block barrier per bucket. One tile is one bucket, so the epilogue is
//      a row maximum in the accumulators: a thread's 32 scores of each of
//      its two queries, then the four threads of the quad by shuffles. The
//      (Q, R) scores never leave registers. The plan (queries per block,
//      buckets per range) is ops/bucket_topk.py::_bucket_max_plan.
//   E  bytes: the (2,048, 2,048) f32 maxima are read once (16.8 MB, 5.0 us
//      at 3.35 TB/s). E is G on the columns: a block takes 8 columns (a
//      32-byte sector of every row; 2,048 / 8 = 256 blocks for 132 SMs,
//      ops/bucket_topk.py::_column_topk_plan), streams its rows through a
//      four-stage ring of 256-row tiles in shared memory by 16-byte
//      cp.async copies (4-byte ones where rows are not 16-byte aligned), so
//      copies stay in flight while the warps compare, and one warp takes
//      each column, its lanes over the rows, as G's lanes are over a row.
//   F  bytes: 34 MB of keys in, a 33.5 MB panel array out. One warpgroup
//      per bucket: the bucket's keys are the B tile, its slots' query rows,
//      64 at a time, a gathered A tile (cp.async from each slot's row, zero
//      for an empty slot; the TPU selected them with a one-hot matmul). The
//      panel is stored from the accumulators, two neighbouring keys a thread
//      (8 bytes), so a warp's store fills whole 32-byte sectors.
//   G  bytes: a (2,048, 1,280) f32 candidate matrix (10.5 MB, 3.2 us).
//      One warp per row and no copy of the row: a lane issues 10 16-byte
//      loads (the path's 40 values a lane) before it compares. Occupancy
//      is set by registers alone, and a row may be of any width.
//   E and G select in registers (rg_topk.cuh): one list a warp of 32, 64
//      or 128 entries, sorted across the lanes, behind its own k-th entry.
//
// Ties: E and G resolve to the lowest row / column, and once a column or row
// is exhausted they repeat (-3e38, 0), as the TPU kernels do for inputs that
// are all at least -3e38 (NaN and -inf are not ordered here).
//
// Every width and every k: D and F take rows of any multiple of 8 columns
// (the wrappers pad), rows wider than 256 in chunks of 128 columns in the
// same order in both (rg_mma.cuh), so D's maxima stay F's scores to the
// bit. E and G take k <= 128; the wrappers route a larger k to the
// selection family (select_topk.cu). rg_score_matrix is D's tile with
// every score stored: the scores of kernel C's k > 128 path.

#include <math.h>

#include "rg_mma.cuh"
#include "rg_tile.cuh"
#include "rg_topk.cuh"

namespace {

using rg::kFull;
using rg::kNegInf;

constexpr int kLane = rgm::kTileN;  // keys per bucket: one B tile

cudaError_t allow_smem(const void* kernel, size_t bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// ---- D and F: the key tile's live flags ------------------------------------

// The live flags of the 128 keys from r0 (below n_r, and valid where a mask
// is given): lane l reads keys 32u + l, u = 0..3.
__device__ __forceinline__ void key_flags(const uint8_t* __restrict__ valid,
                                          long long r0, int n_r,
                                          bool (&f)[4]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const long long gr = r0 + 32 * u + lane;
    f[u] = gr < n_r && (valid == nullptr || valid[gr] != 0);
  }
}

// The warp's ballots of those flags: word[u] bit i says key 32u + i is
// live, shifted down to this thread's first key column 2 * (lane % 4).
// Returns whether all 128 keys are live. Called by all 32 lanes.
__device__ __forceinline__ bool key_words(const bool (&f)[4],
                                          unsigned (&word)[4]) {
  const int lane = threadIdx.x & 31;
  unsigned all = kFull;
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const unsigned w = __ballot_sync(kFull, f[u]);
    all &= w;
    word[u] = w >> (2 * (lane & 3));
  }
  return all == kFull;
}

// Whether the key of accumulator v (key 8j + 2(lane % 4) + v % 2, j = v / 4;
// rg_mma.cuh's fragment layout) is live.
__device__ __forceinline__ bool key_live(const unsigned (&word)[4], int v) {
  const int j = v >> 2;
  return (word[j >> 2] >> ((8 * j) % 32 + (v & 1))) & 1u;
}

// ---- D ---------------------------------------------------------------------

// kWG warpgroups, 64 queries each, share every key tile; block (x, y) takes
// queries 64 * kWG * x onwards against buckets per_block * y onwards, one
// bucket a key tile of rg_mma.cuh's TileWalk (kChunk: rows wider than
// rgm::kResidentE). kStore: the score matrix of the selection family
// instead of D's maxima: every score is written, out[q * ld + r] with ld =
// n_buckets * 128, -3e38 for a masked key or one past R.
template <int kWG, bool kChunk, bool kStore>
__global__ void __launch_bounds__(128 * kWG, 4 / kWG)
bucket_max_kernel(const __nv_bfloat16* __restrict__ keys,
                  const __nv_bfloat16* __restrict__ q,
                  const uint8_t* __restrict__ valid, float* __restrict__ out,
                  int n_r, int n_q, int e, int n_buckets, int per_block) {
  constexpr int kThreads = 128 * kWG;
  constexpr int kBQ = 64 * kWG;
  extern __shared__ uint8_t smem_raw[];
  const int q0 = blockIdx.x * kBQ;
  const int b_begin = blockIdx.y * per_block;
  const int b_end = min(n_buckets, b_begin + per_block);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  // this thread's queries: accumulator rows h = 0, 1
  const int row0 = q0 + 16 * warp + (lane >> 2);
  rgm::TileWalk<kThreads, kBQ, kChunk> walk(
      rgm::aligned_smem(smem_raw), q, keys, q0, n_q,
      (long long)b_begin * kLane, n_r, b_end - b_begin, e);
  walk.start();
  bool nf[4];
  key_flags(valid, (long long)b_begin * kLane, n_r, nf);

  for (int b = b_begin; b < b_end; ++b) {
    walk.begin(b - b_begin);
    unsigned word[4];
    const bool all_live = key_words(nf, word);
    if (b + 1 < b_end) key_flags(valid, (long long)(b + 1) * kLane, n_r, nf);
    float acc[rgm::kAcc];
    walk.product(acc, b - b_begin, rgm::kTileM * (warp / 4));
    // acc[4j + 2h + x] is query row0 + 8h against key 8j + 2(lane % 4) + x;
    // a masked key scores -3e38
    if (!all_live) {
#pragma unroll
      for (int v = 0; v < rgm::kAcc; ++v)
        if (!key_live(word, v)) acc[v] = kNegInf;
    }
    if constexpr (kStore) {
      // two neighbouring keys a thread: a quad writes 32 bytes of a row
      const long long r0 = (long long)b * kLane + 2 * (lane & 3);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int gq = row0 + 8 * h;
        if (gq >= n_q) continue;
        float* row = out + (long long)gq * n_buckets * kLane + r0;
#pragma unroll
        for (int j = 0; j < rgm::kAcc / 4; ++j)
          *reinterpret_cast<float2*>(row + 8 * j) =
              make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
      }
    } else {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        // the maximum of 32 scores as a tree (fmaxf is exact, so the order
        // does not change the result), then over the quad
        float m[16];
#pragma unroll
        for (int j = 0; j < 16; ++j)
          m[j] = fmaxf(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
#pragma unroll
        for (int j = 0; j < 8; ++j) m[j] = fmaxf(m[j], m[j + 8]);
#pragma unroll
        for (int j = 0; j < 4; ++j) m[j] = fmaxf(m[j], m[j + 4]);
        m[0] = fmaxf(fmaxf(m[0], m[2]), fmaxf(m[1], m[3]));
        float best = fmaxf(m[0], __shfl_xor_sync(kFull, m[0], 1));
        best = fmaxf(best, __shfl_xor_sync(kFull, best, 2));
        const int gq = row0 + 8 * h;
        if ((lane & 3) == h && gq < n_q) out[(long long)b * n_q + gq] = best;
      }
    }
  }
}

template <int kWG, bool kChunk, bool kStore>
cudaError_t launch_bucket_max(const dim3& grid, size_t smem, cudaStream_t s,
                              const __nv_bfloat16* keys,
                              const __nv_bfloat16* q, const uint8_t* valid,
                              float* out, int n_r, int n_q, int e,
                              int n_buckets, int per_block) {
  cudaError_t err = cudaFuncSetAttribute(
      bucket_max_kernel<kWG, kChunk, kStore>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  bucket_max_kernel<kWG, kChunk, kStore><<<grid, 128 * kWG, smem, s>>>(
      keys, q, valid, out, n_r, n_q, e, n_buckets, per_block);
  return cudaGetLastError();
}

// D (store = false) or the score matrix (store = true) with the plan
// (block_q, per_block); the shared checks of both entry points.
int run_score_tiles(bool store, const void* keys, const void* q,
                    const void* valid, void* out, int n_r, int n_q, int e,
                    int block_q, int per_block, void* stream) {
  if (n_r == 0 || n_q == 0) return (int)cudaGetLastError();
  if ((block_q != 64 && block_q != 128) || per_block < 1 || e < 8 ||
      e % 8 != 0)
    return (int)cudaErrorInvalidValue;
  const int n_buckets = (n_r + kLane - 1) / kLane;
  const int ranges = (n_buckets + per_block - 1) / per_block;
  if (ranges > 65535) return (int)cudaErrorInvalidValue;
  const size_t smem = rgm::kAlign + rgm::ring_bytes(block_q, e);
  const dim3 grid((n_q + block_q - 1) / block_q, ranges);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* kh = static_cast<const __nv_bfloat16*>(keys);
  const auto* qh = static_cast<const __nv_bfloat16*>(q);
  const auto* vb = static_cast<const uint8_t*>(valid);
  auto* o = static_cast<float*>(out);
#define RG_SCORE_LAUNCH(WG, CH, ST)                                          \
  return (int)launch_bucket_max<WG, CH, ST>(grid, smem, s, kh, qh, vb, o,    \
                                            n_r, n_q, e, n_buckets,          \
                                            per_block)
  const bool chunk = rgm::chunked(e);
  if (store) {
    if (block_q == 128) {
      if (chunk) RG_SCORE_LAUNCH(2, true, true);
      RG_SCORE_LAUNCH(2, false, true);
    }
    if (chunk) RG_SCORE_LAUNCH(1, true, true);
    RG_SCORE_LAUNCH(1, false, true);
  }
  if (block_q == 128) {
    if (chunk) RG_SCORE_LAUNCH(2, true, false);
    RG_SCORE_LAUNCH(2, false, false);
  }
  if (chunk) RG_SCORE_LAUNCH(1, true, false);
  RG_SCORE_LAUNCH(1, false, false);
#undef RG_SCORE_LAUNCH
}

// ---- E ---------------------------------------------------------------------

constexpr int kECols = 8;     // columns per block, one warp each: a 32-byte
                              // sector of every row
constexpr int kETile = 256;   // rows per stage of the copy ring: 8 a lane
constexpr int kEStages = 4;
constexpr int kEStage = kETile * kECols;  // floats per stage

// Element (r, c) of a stage: rows of 8 floats, the two 16-byte halves
// swapped in every other group of four rows, so that a warp reading one
// column over 32 rows meets each bank it touches 4 times, not 8.
__device__ __forceinline__ int e_at(int r, int c) {
  return r * kECols + (c ^ (r & 4));
}

// Stage rows r0 .. r0 + kETile - 1 (those below n_r) of the block's
// columns c0 .. c0 + 7 (those below n_q), all threads of the block: 16-byte
// copies where every row starts 16-byte aligned, else 4-byte ones.
template <bool kVec>
__device__ __forceinline__ void e_stage(const float* __restrict__ x,
                                        float* st, int r0, int n_r, int c0,
                                        int n_q) {
  constexpr int kChunk = kVec ? 4 : 1;
  for (int c = threadIdx.x; c < kEStage / kChunk; c += blockDim.x) {
    const int row = c / (kECols / kChunk);
    const int col = c % (kECols / kChunk) * kChunk;
    if (r0 + row >= n_r || c0 + col >= n_q) continue;
    const float* src = x + (long long)(r0 + row) * n_q + c0 + col;
    if (kVec)
      rgk::cp_async16(st + e_at(row, col), src);
    else
      rgk::cp_async4(st + e_at(row, col), src);
  }
}

// Block x takes columns 8x .. 8x + 7, warp w column 8x + w, lane l rows l,
// l + 32, ... of every stage (rg_topk.cuh's selector for k <= KCAP).
template <int KCAP, bool kVec>
__global__ void __launch_bounds__(32 * kECols)
column_topk_kernel(const float* __restrict__ x, float* __restrict__ out_v,
                   int* __restrict__ out_i, int n_r, int n_q, int k) {
  constexpr int kPer = kETile / 32;  // a lane's rows in a stage
  extern __shared__ __align__(16) float ring[];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  const int c0 = blockIdx.x * kECols;
  const int col = c0 + warp;
  const int n_tiles = (n_r + kETile - 1) / kETile;
  rgk::TopK<KCAP> top;
  top.init(k);

  for (int s = 0; s < kEStages - 1; ++s) {
    if (s < n_tiles)
      e_stage<kVec>(x, ring + s * kEStage, s * kETile, n_r, c0, n_q);
    rgk::cp_async_commit();
  }
  for (int t = 0; t < n_tiles; ++t) {
    // tile t has landed, and every warp is done with tile t - 1, whose
    // stage takes tile t + kEStages - 1
    rgk::cp_async_wait<kEStages - 2>();
    __syncthreads();
    const int nt = t + kEStages - 1;
    if (nt < n_tiles)
      e_stage<kVec>(x, ring + nt % kEStages * kEStage, nt * kETile, n_r, c0,
                    n_q);
    rgk::cp_async_commit();
    if (col < n_q) {
      const float* st = ring + t % kEStages * kEStage;
      const int r0 = t * kETile + lane;
      float buf[kPer];
#pragma unroll
      for (int u = 0; u < kPer; ++u)
        buf[u] = r0 + 32 * u < n_r ? st[e_at(lane + 32 * u, warp)] : kNegInf;
      top.take(buf, [&](int u) { return r0 + 32 * u; });
    }
  }
  if (col < n_q)
    top.write(out_v + (long long)col * k, out_i + (long long)col * k);
}

template <int KCAP>
cudaError_t launch_column_topk(bool vec, const float* x, float* out_v,
                               int* out_i, int n_r, int n_q, int k,
                               cudaStream_t s) {
  auto kernel = vec ? column_topk_kernel<KCAP, true>
                    : column_topk_kernel<KCAP, false>;
  constexpr size_t smem = sizeof(float) * kEStages * kEStage;
  cudaError_t err = allow_smem((const void*)kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<(n_q + kECols - 1) / kECols, 32 * kECols, smem, s>>>(
      x, out_v, out_i, n_r, n_q, k);
  return cudaGetLastError();
}

// ---- F ---------------------------------------------------------------------

// One warpgroup per bucket: the bucket's 128 keys are the B tile, and the
// query rows of its slots, 64 at a time, the gathered A tile. kChunk: rows
// wider than rgm::kResidentE, the pair of tiles loaded one chunk of
// rgm::kChunkE columns at a time, by rgm::mma_row as D's.
template <bool kChunk>
__global__ void __launch_bounds__(rgm::kTileN)
bucket_rescore_kernel(const int* __restrict__ assign,
                      const __nv_bfloat16* __restrict__ q,
                      const __nv_bfloat16* __restrict__ keys,
                      const uint8_t* __restrict__ valid,
                      float* __restrict__ out, int p_max, int n_q, int n_r,
                      int e) {
  constexpr int kThreads = 128;
  constexpr int kSlots = rgm::kTileM;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = rgm::aligned_smem(smem_raw);
  const uint32_t ks = rgm::smem_addr(smem);
  const uint32_t qs = ks + (uint32_t)rgm::piece_bytes(kLane, e);

  const int b = blockIdx.x;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  const long long r0 = (long long)b * kLane;
  const int* ids = assign + (long long)b * p_max;
  if constexpr (!kChunk) {
    rgm::load_tile<kThreads>(keys, ks, r0, kLane, n_r, e);
    rgm::load_gathered_tile<kThreads>(q, qs, ids, min(p_max, kSlots), kSlots,
                                      n_q, e);
    rgm::cp_async_commit();
  }
  bool f[4];
  key_flags(valid, r0, n_r, f);
  unsigned word[4];
  const bool all_live = key_words(f, word);
  float* panel = out + (long long)b * p_max * kLane;
  const int col = 2 * (lane & 3);

  for (int p0 = 0; p0 < p_max; p0 += kSlots) {
    float acc[rgm::kAcc];
    rgm::mma_row<kChunk>(acc, e, kSlots, 0, [&](int c) {
      if constexpr (kChunk) {
        const int c0 = c * rgm::kChunkE, w = rgm::piece_width(e, c);
        __syncthreads();  // every warp's products have read the last chunk
        rgm::load_tile<kThreads>(keys, ks, r0, kLane, n_r, e, c0, w);
        rgm::load_gathered_tile<kThreads>(q, qs, ids + p0,
                                          min(p_max - p0, kSlots), kSlots,
                                          n_q, e, c0, w);
        rgm::cp_async_commit();
      }
      rgm::cp_async_wait<0>();
      __syncthreads();
      return make_uint2(qs, ks);
    });
    if (!kChunk && p0 + kSlots < p_max) {
      __syncthreads();  // every warp's products have read these slots' rows
      rgm::load_gathered_tile<kThreads>(q, qs, ids + p0 + kSlots,
                                        min(p_max - p0 - kSlots, kSlots),
                                        kSlots, n_q, e);
      rgm::cp_async_commit();
    }
    // acc[4j + 2h + x] is slot p0 + 16 * warp + lane / 4 + 8h against key
    // 8j + col + x
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int p = p0 + 16 * warp + (lane >> 2) + 8 * h;
      if (p >= p_max) continue;
      float* row = panel + (long long)p * kLane + col;
#pragma unroll
      for (int j = 0; j < rgm::kAcc / 4; ++j) {
        const int v = 4 * j + 2 * h;
        *reinterpret_cast<float2*>(row + 8 * j) =
            make_float2(all_live || key_live(word, v) ? acc[v] : kNegInf,
                        all_live || key_live(word, v + 1) ? acc[v + 1]
                                                          : kNegInf);
      }
    }
  }
}

// ---- G ---------------------------------------------------------------------

// Values a lane holds in a batch: 10 16-byte loads (the path's row of
// 1,280 values, 40 a lane, in one batch), or 20 4-byte loads where rows
// are not 16-byte aligned
template <bool kVec>
constexpr int kGBatch = kVec ? 40 : 20;

// One warp per row, blockDim = 32 * warps. A lane takes the row's 16-byte
// chunks lane, lane + 32, ... (4-byte values where the row does not start
// 16-byte aligned), a batch of loads in flight before it compares
// (rg_topk.cuh's selector for k <= KCAP).
template <int KCAP, bool kVec>
__global__ void __launch_bounds__(128, 4)
row_topk_kernel(const float* __restrict__ x, float* __restrict__ out_v,
                int* __restrict__ out_i, int n_q, int w, int k) {
  constexpr int kN = kGBatch<kVec>;
  const int warps = blockDim.x / 32;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * warps + threadIdx.x / 32;
  if (row >= n_q) return;
  const float* src = x + (long long)row * w;
  rgk::TopK<KCAP> top;
  top.init(k);
  for (int b = 0; b < w; b += 32 * kN) {
    float buf[kN];
    if (kVec) {
      const float4* src4 = reinterpret_cast<const float4*>(src + b);
#pragma unroll
      for (int u = 0; u < kN / 4; ++u) {
        const float4 f = b + 4 * (lane + 32 * u) < w
                             ? __ldg(src4 + lane + 32 * u)
                             : make_float4(kNegInf, kNegInf, kNegInf, kNegInf);
        buf[4 * u] = f.x;
        buf[4 * u + 1] = f.y;
        buf[4 * u + 2] = f.z;
        buf[4 * u + 3] = f.w;
      }
      top.take(buf,
               [&](int u) { return b + 4 * (lane + 32 * (u / 4)) + u % 4; });
    } else {
#pragma unroll
      for (int u = 0; u < kN; ++u) {
        const int c = b + lane + 32 * u;
        buf[u] = c < w ? __ldg(src + c) : kNegInf;
      }
      top.take(buf, [&](int u) { return b + lane + 32 * u; });
    }
  }
  top.write(out_v + (long long)row * k, out_i + (long long)row * k);
}

template <int KCAP>
cudaError_t launch_row_topk(bool vec, const float* x, float* out_v,
                            int* out_i, int n_q, int w, int k, int warps,
                            cudaStream_t s) {
  auto kernel =
      vec ? row_topk_kernel<KCAP, true> : row_topk_kernel<KCAP, false>;
  kernel<<<(n_q + warps - 1) / warps, 32 * warps, 0, s>>>(x, out_v, out_i,
                                                         n_q, w, k);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Kernel D. keys (R, E) and q (Q, E) bf16, row-major, 16-byte aligned,
// E % 8 == 0 (rows wider than 256 in chunks of 128 columns); valid (R,)
// uint8 or null. out is (ceil(R / 128), Q) f32: the largest score of each
// query in each bucket of 128 consecutive keys, -3e38 where the bucket has
// no valid key. The plan: block_q (64 or 128) queries per block, per_block
// buckets per block.
int rg_bucket_max(const void* keys, const void* q, const void* valid,
                  void* out, int n_r, int n_q, int e, int block_q,
                  int per_block, void* stream) {
  return run_score_tiles(false, keys, q, valid, out, n_r, n_q, e, block_q,
                         per_block, stream);
}

// The score matrix of the selection family (select_topk.cu): D's tiles
// with every score stored. out is (Q, ceil(R / 128) * 128) f32: out[q, r]
// is query q's score against key r, -3e38 for an invalid key and for r
// from R to the end of the last bucket. The scores are bitwise those of D,
// F and kernel C at the same E. Arguments as D's.
int rg_score_matrix(const void* keys, const void* q, const void* valid,
                    void* out, int n_r, int n_q, int e, int block_q,
                    int per_block, void* stream) {
  return run_score_tiles(true, keys, q, valid, out, n_r, n_q, e, block_q,
                         per_block, stream);
}

// Kernel E. x (R, Q) f32 row-major, every value >= -3e38. out_v / out_i are
// (Q, k): each column's k largest values, descending, with their rows; ties
// to the lowest row; (-3e38, 0) once a column has no value above -3e38 left.
// The plan (ops/bucket_topk.py::_column_topk_plan): kcap 32, 64 or 128, one
// list of that length a warp, k <= kcap; `cols` columns per block, which
// must be the kernel's 8.
int rg_column_topk(const void* x, void* out_v, void* out_i, int n_r, int n_q,
                   int k, int kcap, int cols, void* stream) {
  if (n_q == 0) return (int)cudaGetLastError();
  if (k < 1 || k > kcap || (kcap != 32 && kcap != 64 && kcap != 128) ||
      cols != kECols || n_r < 1)
    return (int)cudaErrorInvalidValue;
  const bool vec = n_q % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const auto* xf = static_cast<const float*>(x);
  auto* ov = static_cast<float*>(out_v);
  auto* oi = static_cast<int*>(out_i);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (kcap) {
    case 32:
      return (int)launch_column_topk<32>(vec, xf, ov, oi, n_r, n_q, k, s);
    case 64:
      return (int)launch_column_topk<64>(vec, xf, ov, oi, n_r, n_q, k, s);
    default:
      return (int)launch_column_topk<128>(vec, xf, ov, oi, n_r, n_q, k, s);
  }
}

// Kernel F. assign (nb, P) int32 query ids, an id outside [0, Q) marks an
// empty slot; q (Q, E), keys (R, E) bf16 as for D; nb = ceil(R / 128). out is
// (nb, P, 128) f32: the score of slot p's query against key l of bucket b,
// -3e38 where that key is invalid or past R, 0 in an empty slot of a valid
// key.
int rg_bucket_rescore(const void* assign, const void* q, const void* keys,
                      const void* valid, void* out, int n_buckets, int p_max,
                      int n_q, int n_r, int e, void* stream) {
  if (n_buckets == 0 || p_max == 0) return (int)cudaGetLastError();
  if (e < 8 || e % 8 != 0) return (int)cudaErrorInvalidValue;
  const bool chunk = rgm::chunked(e);
  const size_t smem = rgm::kAlign + rgm::piece_bytes(kLane, e) +
                      rgm::piece_bytes(rgm::kTileM, e);
  auto kernel =
      chunk ? bucket_rescore_kernel<true> : bucket_rescore_kernel<false>;
  cudaError_t err = allow_smem((const void*)kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<n_buckets, rgm::kTileN, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(assign), static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(keys),
      static_cast<const uint8_t*>(valid), static_cast<float*>(out), p_max,
      n_q, n_r, e);
  return (int)cudaGetLastError();
}

// Kernel G. x (Q, W) f32 row-major, every value >= -3e38, any W >= 1.
// out_v / out_i are (Q, k): each row's k largest values, descending, with
// their columns; ties to the lowest column; (-3e38, 0) once a row is
// exhausted.
// The plan (ops/bucket_topk.py::_row_topk_plan): kcap as for E, `warps`
// rows per block (1 to 4).
int rg_row_topk(const void* x, void* out_v, void* out_i, int n_q, int w,
                int k, int kcap, int warps, void* stream) {
  if (n_q == 0) return (int)cudaGetLastError();
  if (k < 1 || k > kcap || (kcap != 32 && kcap != 64 && kcap != 128) ||
      warps < 1 || warps > 4 || w < 1)
    return (int)cudaErrorInvalidValue;
  const bool vec = w % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const auto* xf = static_cast<const float*>(x);
  auto* ov = static_cast<float*>(out_v);
  auto* oi = static_cast<int*>(out_i);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (kcap) {
    case 32:
      return (int)launch_row_topk<32>(vec, xf, ov, oi, n_q, w, k, warps, s);
    case 64:
      return (int)launch_row_topk<64>(vec, xf, ov, oi, n_q, w, k, warps, s);
    default:
      return (int)launch_row_topk<128>(vec, xf, ov, oi, n_q, w, k, warps, s);
  }
}

}  // extern "C"
