// The four kernels of the two-phase exact bucket top-k (kernels D, E, F, G).
//
// They replace the Pallas kernels of ragraph_tpu/ops/bucket_topk.py:
//   D  rg_bucket_max      _bucket_max_kernel  scores reduced to the maximum of
//                                             each 128-key bucket
//   E  rg_column_topk     _col_topk_kernel    per-column top-k of (R, Q)
//   F  rg_bucket_rescore  _rescore_kernel     exact scores of each bucket's
//                                             assigned queries
//   G  rg_row_topk        _row_topk_kernel    per-row top-k of (Q, W)
// The glue between them (pair inversion, overflow fallback, index math) is
// PyTorch code in ragraph_tpu_torch/ops/bucket_topk.py.
//
// Exactness across the phases needs D's maxima to be the very values F
// returns: both add the exact bf16 products in rg::fma4's order (rg_tile.cuh).
// Kernel C sums the same products on the tensor cores, in another order.
//
// What bounds each on an H100, at Q = 2,048 queries, R = 262,144 keys,
// E = 64, k = 10:
//   D  operations: 2*Q*R*E = 68.7 GFLOP (0.07 ms at the bf16 tensor-core
//      rate) against 34 MB of input and a 16.8 MB result. This version
//      multiplies with f32 FMAs, and so runs far above the bound; moving it
//      onto rg_mma.cuh's tensor-core tile is later work. It takes a 64 x 64
//      tile with a 4 x 4 register tile per thread, and reduces each thread's
//      four keys, then the 16 threads of a query row, with shuffles: the
//      (Q, R) scores never leave registers.
//   E  bytes: the (2,048, 2,048) f32 maxima are read once (16.8 MB). Columns
//      are strided in memory, so a warp takes 32 neighbouring columns of one
//      row (a 128-byte line) and the rows are dealt out over the block's
//      warps; each thread keeps a sorted list of k entries in shared memory
//      and inserts only values above its k-th, and one warp merges the lists.
//   F  bytes: 34 MB of keys in, a 33.5 MB panel array out; one block per
//      bucket holds the 128 keys in shared memory and gathers its assigned
//      query rows directly (the TPU selected them with a one-hot matmul).
//   G  bytes: a (2,048, 1,280) f32 candidate matrix (10.5 MB). One warp per
//      row holds it in shared memory and runs k rounds of a warp arg-max.
//
// Ties: E and G resolve to the lowest row / column, and once a column or row
// is exhausted they repeat (-3e38, 0), as the TPU kernels do for inputs that
// are all at least -3e38 (NaN and -inf are not ordered here).

#include <math.h>

#include "rg_tile.cuh"

namespace {

using rg::fma4;
using rg::kFull;
using rg::kNegInf;

constexpr int kLane = 128;     // keys per bucket
constexpr int kBQ = 64;        // D: queries per block
constexpr int kBR = 64;        // D: keys per tile (half a bucket)
constexpr int kThreads = 256;  // D
constexpr int kBucketsPerBlock = 8;  // D: buckets one block walks over
constexpr int kColsPerBlock = 32;    // E: one warp's width
constexpr int kSlotTile = 4;         // F: slots scored per pass over a key

// ---- D ---------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads)
bucket_max_kernel(const __nv_bfloat16* __restrict__ keys,
                  const __nv_bfloat16* __restrict__ q,
                  const uint8_t* __restrict__ valid, float* __restrict__ out,
                  int n_r, int n_q, int e, int n_buckets) {
  extern __shared__ __align__(16) float smem[];
  const int ld = e + 4;
  float* qs = smem;               // (BQ, E+4)
  float* ks = qs + kBQ * ld;      // (BR, E+4)
  int* kv = reinterpret_cast<int*>(ks + kBR * ld);  // (BR,) key is live

  const int q0 = blockIdx.x * kBQ;
  const int b_begin = blockIdx.y * kBucketsPerBlock;
  const int b_end = min(n_buckets, b_begin + kBucketsPerBlock);
  const int tid = threadIdx.x;
  const int ty = tid / 16;  // queries 4*ty .. 4*ty+3
  const int tx = tid % 16;  // keys tx, tx+16, tx+32, tx+48

  rg::load_rows<kThreads>(q, qs, q0, kBQ, n_q, e);

  for (int b = b_begin; b < b_end; ++b) {
    float best[4] = {kNegInf, kNegInf, kNegInf, kNegInf};
    for (int half = 0; half < kLane / kBR; ++half) {
      const long long r0 = (long long)b * kLane + half * kBR;
      __syncthreads();  // the previous tile has been read (and qs written)
      rg::load_rows<kThreads>(keys, ks, r0, kBR, n_r, e);
      for (int t = tid; t < kBR; t += kThreads) {
        const long long gr = r0 + t;
        kv[t] = gr < n_r && (valid == nullptr || valid[gr] != 0);
      }
      __syncthreads();

      float acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
      for (int c = 0; c < e; c += 4) {
        float4 a[4], bb[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          a[i] = *reinterpret_cast<const float4*>(qs + (4 * ty + i) * ld + c);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          bb[j] =
              *reinterpret_cast<const float4*>(ks + (tx + 16 * j) * ld + c);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) fma4(acc[i][j], a[i], bb[j]);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool live = kv[tx + 16 * j] != 0;
#pragma unroll
        for (int i = 0; i < 4; ++i)
          best[i] = fmaxf(best[i], live ? acc[i][j] : kNegInf);
      }
    }
    // the 16 threads of a query row are neighbouring lanes of one warp
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        best[i] = fmaxf(best[i], __shfl_xor_sync(kFull, best[i], off));
    }
    if (tx == 0) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int gq = q0 + 4 * ty + i;
        if (gq < n_q) out[(long long)b * n_q + gq] = best[i];
      }
    }
  }
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

// One block of 128 threads per bucket; thread t owns key t of the bucket.
__global__ void __launch_bounds__(kLane)
bucket_rescore_kernel(const int* __restrict__ assign,
                      const __nv_bfloat16* __restrict__ q,
                      const __nv_bfloat16* __restrict__ keys,
                      const uint8_t* __restrict__ valid,
                      float* __restrict__ out, int p_max, int n_q, int n_r,
                      int e) {
  extern __shared__ __align__(16) float smem[];
  const int ld = e + 4;
  float* ks = smem;                 // (128, E+4)
  float* qs = ks + kLane * ld;      // (kSlotTile, E+4)
  __shared__ int qid[kSlotTile];

  const int b = blockIdx.x;
  const int t = threadIdx.x;
  const long long r0 = (long long)b * kLane;
  rg::load_rows<kLane>(keys, ks, r0, kLane, n_r, e);
  const long long gr = r0 + t;
  const bool live = gr < n_r && (valid == nullptr || valid[gr] != 0);
  float* panel = out + (long long)b * p_max * kLane;

  for (int p0 = 0; p0 < p_max; p0 += kSlotTile) {
    __syncthreads();  // keys loaded; the previous slots' rows have been read
    if (t < kSlotTile) {
      const int p = p0 + t;
      qid[t] = p < p_max ? assign[(long long)b * p_max + p] : n_q;
    }
    __syncthreads();
    // an empty slot (id >= Q) reads as a zero row
    for (int u = t; u < kSlotTile * (e / 8); u += kLane) {
      const int s = u / (e / 8);
      const int c = u - s * (e / 8);
      const int id = qid[s];
      rg::load8(id >= 0 && id < n_q ? q + (long long)id * e + c * 8 : nullptr,
                qs + s * ld + c * 8);
    }
    __syncthreads();
    float acc[kSlotTile];
#pragma unroll
    for (int s = 0; s < kSlotTile; ++s) acc[s] = 0.f;
    for (int c = 0; c < e; c += 4) {
      const float4 kk = *reinterpret_cast<const float4*>(ks + t * ld + c);
#pragma unroll
      for (int s = 0; s < kSlotTile; ++s)
        fma4(acc[s], *reinterpret_cast<const float4*>(qs + s * ld + c), kk);
    }
#pragma unroll
    for (int s = 0; s < kSlotTile; ++s)
      if (p0 + s < p_max)
        panel[(long long)(p0 + s) * kLane + t] = live ? acc[s] : kNegInf;
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

// Kernel D. keys (R, E) and q (Q, E) bf16, row-major, E % 8 == 0, E <= 256;
// valid (R,) uint8 or null. out is (ceil(R / 128), Q) f32: the largest score
// of each query in each bucket of 128 consecutive keys, -3e38 where the
// bucket has no valid key.
int rg_bucket_max(const void* keys, const void* q, const void* valid,
                  void* out, int n_r, int n_q, int e, void* stream) {
  if (n_r == 0 || n_q == 0) return (int)cudaGetLastError();
  const int n_buckets = (n_r + kLane - 1) / kLane;
  const size_t smem =
      sizeof(float) * (kBQ + kBR) * ((size_t)e + 4) + sizeof(int) * kBR;
  cudaError_t err = allow_smem((const void*)bucket_max_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((n_q + kBQ - 1) / kBQ,
                  (n_buckets + kBucketsPerBlock - 1) / kBucketsPerBlock);
  bucket_max_kernel<<<grid, kThreads, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(keys),
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const uint8_t*>(valid), static_cast<float*>(out), n_r, n_q,
      e, n_buckets);
  return (int)cudaGetLastError();
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
  const size_t smem = sizeof(float) * (kLane + kSlotTile) * ((size_t)e + 4);
  cudaError_t err = allow_smem((const void*)bucket_rescore_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  bucket_rescore_kernel<<<n_buckets, kLane, smem,
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
