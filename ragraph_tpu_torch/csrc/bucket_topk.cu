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
//   E  bytes: the (2,048, 2,048) f32 maxima are read once (16.8 MB). Columns
//      are strided in memory, so a warp takes 32 neighbouring columns of one
//      row (a 128-byte line) and the rows are dealt out over the block's
//      warps; each thread keeps a sorted list of k entries in shared memory
//      and inserts only values above its k-th, and one warp merges the lists.
//   F  bytes: 34 MB of keys in, a 33.5 MB panel array out. One warpgroup
//      per bucket: the bucket's keys are the B tile, its slots' query rows,
//      64 at a time, a gathered A tile (cp.async from each slot's row, zero
//      for an empty slot; the TPU selected them with a one-hot matmul). The
//      panel is stored from the accumulators, two neighbouring keys a thread
//      (8 bytes), so a warp's store fills whole 32-byte sectors.
//   G  bytes: a (2,048, 1,280) f32 candidate matrix (10.5 MB). One warp per
//      row holds it in shared memory and runs k rounds of a warp arg-max.
//
// Ties: E and G resolve to the lowest row / column, and once a column or row
// is exhausted they repeat (-3e38, 0), as the TPU kernels do for inputs that
// are all at least -3e38 (NaN and -inf are not ordered here).

#include <math.h>

#include "rg_mma.cuh"
#include "rg_tile.cuh"

namespace {

using rg::kFull;
using rg::kNegInf;

constexpr int kLane = rgm::kTileN;  // keys per bucket: one B tile
constexpr int kColsPerBlock = 32;   // E: one warp's width

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
// queries 64 * kWG * x onwards against buckets per_block * y onwards.
template <int kWG>
__global__ void __launch_bounds__(128 * kWG, 4 / kWG)
bucket_max_kernel(const __nv_bfloat16* __restrict__ keys,
                  const __nv_bfloat16* __restrict__ q,
                  const uint8_t* __restrict__ valid, float* __restrict__ out,
                  int n_r, int n_q, int e, int n_buckets, int per_block) {
  constexpr int kThreads = 128 * kWG;
  constexpr int kBQ = 64 * kWG;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = rgm::aligned_smem(smem_raw);
  const uint32_t q_bytes = (uint32_t)rgm::tile_bytes(kBQ, e);
  const uint32_t k_bytes = (uint32_t)rgm::tile_bytes(kLane, e);
  const uint32_t qs = rgm::smem_addr(smem);
  const uint32_t stage[2] = {qs + q_bytes, qs + q_bytes + k_bytes};

  const int q0 = blockIdx.x * kBQ;
  const int b_begin = blockIdx.y * per_block;
  const int b_end = min(n_buckets, b_begin + per_block);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  // this thread's queries: accumulator rows h = 0, 1
  const int row0 = q0 + 16 * warp + (lane >> 2);

  rgm::load_tile<kThreads>(q, qs, q0, kBQ, n_q, e);
  rgm::load_tile<kThreads>(keys, stage[0], (long long)b_begin * kLane, kLane,
                           n_r, e);
  rgm::cp_async_commit();
  bool nf[4];
  key_flags(valid, (long long)b_begin * kLane, n_r, nf);

  for (int b = b_begin; b < b_end; ++b) {
    const int t = b - b_begin;
    // bucket b has landed, and every warp is done with bucket b - 1, whose
    // stage takes bucket b + 1 while bucket b multiplies
    rgm::cp_async_wait<0>();
    __syncthreads();
    if (b + 1 < b_end) {
      rgm::load_tile<kThreads>(keys, stage[(t + 1) & 1],
                               (long long)(b + 1) * kLane, kLane, n_r, e);
      rgm::cp_async_commit();
    }
    unsigned word[4];
    const bool all_live = key_words(nf, word);
    if (b + 1 < b_end) key_flags(valid, (long long)(b + 1) * kLane, n_r, nf);

    float acc[rgm::kAcc];
    rgm::mma_tile(acc, qs, kBQ, rgm::kTileM * (warp / 4), stage[t & 1], e);
    // acc[4j + 2h + x] is query row0 + 8h against key 8j + 2(lane % 4) + x;
    // a masked key scores -3e38
    if (!all_live) {
#pragma unroll
      for (int v = 0; v < rgm::kAcc; ++v)
        if (!key_live(word, v)) acc[v] = kNegInf;
    }
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

template <int kWG>
cudaError_t launch_bucket_max(const dim3& grid, size_t smem, cudaStream_t s,
                              const __nv_bfloat16* keys,
                              const __nv_bfloat16* q, const uint8_t* valid,
                              float* out, int n_r, int n_q, int e,
                              int n_buckets, int per_block) {
  cudaError_t err = cudaFuncSetAttribute(
      bucket_max_kernel<kWG>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  bucket_max_kernel<kWG><<<grid, 128 * kWG, smem, s>>>(
      keys, q, valid, out, n_r, n_q, e, n_buckets, per_block);
  return cudaGetLastError();
}

// ---- E ---------------------------------------------------------------------

// blockDim = (32, S). Thread (tx, ty) owns column blockIdx.x*32 + tx and rows
// ty, ty + S, ...; its sorted list is entry j at ls[j * threads + tid].
__global__ void column_topk_kernel(const float* __restrict__ x,
                                   float* __restrict__ out_v,
                                   int* __restrict__ out_i, int n_r, int n_q,
                                   int k) {
  extern __shared__ __align__(16) float smem[];
  const int threads = blockDim.x * blockDim.y;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  float* ls = smem;                                       // (k, threads)
  int* li = reinterpret_cast<int*>(smem + (size_t)k * threads);
  const int col = blockIdx.x * kColsPerBlock + threadIdx.x;
  const int n_split = blockDim.y;

  for (int j = 0; j < k; ++j) {
    ls[j * threads + tid] = kNegInf;
    li[j * threads + tid] = 0;
  }
  if (col < n_q) {
    float thr = kNegInf;
    for (int r = threadIdx.y; r < n_r; r += n_split) {
      const float v = x[(long long)r * n_q + col];
      if (v > thr) {
        // after every equal value: among ties the lower row stays first
        int j = k - 1;
        while (j > 0 && ls[(j - 1) * threads + tid] < v) {
          ls[j * threads + tid] = ls[(j - 1) * threads + tid];
          li[j * threads + tid] = li[(j - 1) * threads + tid];
          --j;
        }
        ls[j * threads + tid] = v;
        li[j * threads + tid] = r;
        thr = ls[(k - 1) * threads + tid];
      }
    }
  }
  __syncthreads();
  if (threadIdx.y != 0 || col >= n_q) return;

  // merge the column's n_split sorted lists: k rounds over their heads,
  // by (value descending, row ascending)
  int head[32];
  for (int s = 0; s < n_split; ++s) head[s] = 0;
  for (int t = 0; t < k; ++t) {
    float bv = -INFINITY;
    int bi = INT32_MAX, bs = -1;
    for (int s = 0; s < n_split; ++s) {
      if (head[s] >= k) continue;
      const int at = head[s] * threads + s * blockDim.x + threadIdx.x;
      const float v = ls[at];
      const int i = li[at];
      if (v > bv || (v == bv && i < bi)) {
        bv = v;
        bi = i;
        bs = s;
      }
    }
    ++head[bs];
    const bool dead = !(bv > kNegInf);
    out_v[(long long)col * k + t] = dead ? kNegInf : bv;
    out_i[(long long)col * k + t] = dead ? 0 : bi;
  }
}

// ---- F ---------------------------------------------------------------------

// One warpgroup per bucket: the bucket's 128 keys are the B tile, and the
// query rows of its slots, 64 at a time, the gathered A tile.
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
  const uint32_t qs = ks + (uint32_t)rgm::tile_bytes(kLane, e);

  const int b = blockIdx.x;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  const long long r0 = (long long)b * kLane;
  const int* ids = assign + (long long)b * p_max;
  rgm::load_tile<kThreads>(keys, ks, r0, kLane, n_r, e);
  rgm::load_gathered_tile<kThreads>(q, qs, ids, min(p_max, kSlots), kSlots,
                                    n_q, e);
  rgm::cp_async_commit();
  bool f[4];
  key_flags(valid, r0, n_r, f);
  unsigned word[4];
  const bool all_live = key_words(f, word);
  float* panel = out + (long long)b * p_max * kLane;
  const int col = 2 * (lane & 3);

  for (int p0 = 0; p0 < p_max; p0 += kSlots) {
    rgm::cp_async_wait<0>();
    __syncthreads();
    float acc[rgm::kAcc];
    rgm::mma_tile(acc, qs, kSlots, 0, ks, e);
    if (p0 + kSlots < p_max) {
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

// One warp per row; the row lives in shared memory while its k maxima are
// taken out one by one.
__global__ void row_topk_kernel(const float* __restrict__ x,
                                float* __restrict__ out_v,
                                int* __restrict__ out_i, int n_q, int w,
                                int k) {
  extern __shared__ __align__(16) float smem[];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * (blockDim.x / 32) + warp;
  if (row >= n_q) return;
  float* xs = smem + (size_t)warp * w;
  const float* src = x + (long long)row * w;
  for (int c = lane; c < w; c += 32) xs[c] = src[c];
  __syncwarp();
  for (int t = 0; t < k; ++t) {
    float bv = -INFINITY;
    int bi = INT32_MAX;
    for (int c = lane; c < w; c += 32) {
      const float v = xs[c];
      if (v > bv) {  // ascending c: the first of equal values stays
        bv = v;
        bi = c;
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(kFull, bv, off);
      const int oi = __shfl_xor_sync(kFull, bi, off);
      if (ov > bv || (ov == bv && oi < bi)) {
        bv = ov;
        bi = oi;
      }
    }
    const bool dead = !(bv > kNegInf);
    if (lane == 0) {
      out_v[(long long)row * k + t] = dead ? kNegInf : bv;
      out_i[(long long)row * k + t] = dead ? 0 : bi;
    }
    if (!dead && (bi & 31) == lane) xs[bi] = kNegInf;
    __syncwarp();
  }
}

cudaError_t allow_smem(const void* kernel, size_t bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace

extern "C" {

// Kernel D. keys (R, E) and q (Q, E) bf16, row-major, 16-byte aligned,
// E % 8 == 0, E <= 256; valid (R,) uint8 or null. out is (ceil(R / 128), Q)
// f32: the largest score of each query in each bucket of 128 consecutive
// keys, -3e38 where the bucket has no valid key. The plan: block_q (64 or
// 128) queries per block, per_block buckets per block.
int rg_bucket_max(const void* keys, const void* q, const void* valid,
                  void* out, int n_r, int n_q, int e, int block_q,
                  int per_block, void* stream) {
  if (n_r == 0 || n_q == 0) return (int)cudaGetLastError();
  if ((block_q != 64 && block_q != 128) || per_block < 1)
    return (int)cudaErrorInvalidValue;
  const int n_buckets = (n_r + kLane - 1) / kLane;
  const int ranges = (n_buckets + per_block - 1) / per_block;
  if (ranges > 65535) return (int)cudaErrorInvalidValue;
  const size_t smem = rgm::kAlign + rgm::tile_bytes(block_q, e) +
                      2 * rgm::tile_bytes(kLane, e);
  const dim3 grid((n_q + block_q - 1) / block_q, ranges);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* kh = static_cast<const __nv_bfloat16*>(keys);
  const auto* qh = static_cast<const __nv_bfloat16*>(q);
  const auto* vb = static_cast<const uint8_t*>(valid);
  auto* o = static_cast<float*>(out);
  return (int)(block_q == 128
                   ? launch_bucket_max<2>(grid, smem, s, kh, qh, vb, o, n_r,
                                          n_q, e, n_buckets, per_block)
                   : launch_bucket_max<1>(grid, smem, s, kh, qh, vb, o, n_r,
                                          n_q, e, n_buckets, per_block));
}

// Kernel E. x (R, Q) f32 row-major, every value >= -3e38. out_v / out_i are
// (Q, k): each column's k largest values, descending, with their rows; ties
// to the lowest row; (-3e38, 0) once a column has no value above -3e38 left.
// n_split in {4, 8, 16, 32} warps share a column block's rows;
// 32 * n_split * k * 8 bytes of shared memory must fit (k <= 128 at 4).
int rg_column_topk(const void* x, void* out_v, void* out_i, int n_r, int n_q,
                   int k, int n_split, void* stream) {
  if (n_q == 0) return (int)cudaGetLastError();
  const size_t smem = (sizeof(float) + sizeof(int)) * (size_t)k *
                      kColsPerBlock * n_split;
  cudaError_t err = allow_smem((const void*)column_topk_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 block(kColsPerBlock, n_split);
  column_topk_kernel<<<(n_q + kColsPerBlock - 1) / kColsPerBlock, block, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(out_v),
      static_cast<int*>(out_i), n_r, n_q, k);
  return (int)cudaGetLastError();
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
  const size_t smem = rgm::kAlign + rgm::tile_bytes(kLane, e) +
                      rgm::tile_bytes(rgm::kTileM, e);
  cudaError_t err = allow_smem((const void*)bucket_rescore_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  bucket_rescore_kernel<<<n_buckets, rgm::kTileN, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(assign), static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(keys),
      static_cast<const uint8_t*>(valid), static_cast<float*>(out), p_max,
      n_q, n_r, e);
  return (int)cudaGetLastError();
}

// Kernel G. x (Q, W) f32 row-major, every value >= -3e38. out_v / out_i are
// (Q, k): each row's k largest values, descending, with their columns; ties
// to the lowest column; (-3e38, 0) once a row is exhausted. `warps` rows per
// block; warps * W * 4 bytes of shared memory must fit.
int rg_row_topk(const void* x, void* out_v, void* out_i, int n_q, int w,
                int k, int warps, void* stream) {
  if (n_q == 0) return (int)cudaGetLastError();
  const size_t smem = sizeof(float) * (size_t)warps * w;
  cudaError_t err = allow_smem((const void*)row_topk_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  row_topk_kernel<<<(n_q + warps - 1) / warps, 32 * warps, smem,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(out_v),
      static_cast<int*>(out_i), n_q, w, k);
  return (int)cudaGetLastError();
}

}  // extern "C"
