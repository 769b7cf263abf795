// Exact fused cosine top-k (kernel C).
//
// Replaces ragraph_tpu/ops/pallas_retrieval.py::_kernel (with _insert_merge
// and _merge_topk): for L2-normalised bf16 queries (Q, E) and keys (R, E),
// the k best scores per query, sorted descending, with their key indices.
// Products of bf16 values are exact in f32 and are summed in f32. Keys whose
// valid flag is 0 score -3e38 and never enter a list; a query with fewer
// than k valid keys gets (-3e38, 0) in its remaining slots. Ties go to the
// lowest key index, and within a run of equal scores the lower index comes
// first.
//
// What bounds it on an H100: operations. One 2,048-query chunk against
// R = 262,144 keys at E = 64 is 2*Q*R*E = 68.7 GFLOP, about 0.07 ms at the
// 989 TFLOP/s bf16 tensor-core rate, against 34 MB of input (0.01 ms). This
// first version multiplies with f32 FMAs (67 TFLOP/s peak), so it runs far
// above that bound; mma.sync / wgmma tiles are later work.
//
// Design: on the TPU the R axis was a sequential grid dimension and one
// running top-k per query lived in VMEM across it. H100 blocks run in no
// order and carry nothing between them, so R is split across blocks too:
// block (x, y) scores 64 queries against the y-th range of keys, 64 keys per
// tile, with a 4x4 register tile per thread fed by 16-byte shared-memory
// loads. The (64, 64) score tile goes to shared memory; each warp then owns 8
// queries and keeps each one's sorted list of k (score, index) pairs in
// shared memory. Only scores above the list's current k-th value are
// inserted, so after the first tiles almost nothing is. A second, small
// launch merges the per-range sorted lists of each query (one warp per
// query, one lane per range) under the same tie rule. The score matrix
// never exists in device memory.

#include <math.h>

#include "rg_tile.cuh"

namespace {

constexpr int kBQ = 64;        // queries per block
constexpr int kBR = 64;        // keys per tile
constexpr int kThreads = 256;  // 8 warps
constexpr int kWarps = kThreads / 32;
using rg::fma4;
using rg::kFull;
using rg::kNegInf;

__host__ __device__ inline size_t smem_bytes(int e, int k) {
  const size_t ld = (size_t)e + 4;
  return sizeof(float) * (2 * kBQ * ld + kBQ * (kBR + 1)) +
         (sizeof(float) + sizeof(int)) * (size_t)kBQ * k + sizeof(int) * kBR;
}

__global__ void __launch_bounds__(kThreads)
topk_partial_kernel(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ keys,
                    const uint8_t* __restrict__ valid,
                    float* __restrict__ part_s, int* __restrict__ part_i,
                    int n_q, int n_r, int e, int k, int splits,
                    int rows_per_split) {
  extern __shared__ __align__(16) float smem[];
  const int ld = e + 4;
  float* qs = smem;                      // (BQ, E+4)
  float* ks = qs + kBQ * ld;             // (BR, E+4)
  float* tile = ks + kBR * ld;           // (BQ, BR+1)
  float* ls = tile + kBQ * (kBR + 1);    // (BQ, k) running scores
  int* li = reinterpret_cast<int*>(ls + kBQ * k);  // (BQ, k) indices
  int* kv = li + kBQ * k;                // (BR,) key is live

  const int q0 = blockIdx.x * kBQ;
  const int split = blockIdx.y;
  const long long r_begin = (long long)split * rows_per_split;
  const long long r_end = min((long long)n_r, r_begin + rows_per_split);
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid & 31;
  const int ty = tid / 16;  // queries 4*ty .. 4*ty+3
  const int tx = tid % 16;  // keys tx, tx+16, tx+32, tx+48

  rg::load_rows<kThreads>(q, qs, q0, kBQ, n_q, e);
  for (int t = tid; t < kBQ * k; t += kThreads) {
    ls[t] = kNegInf;
    li[t] = 0;
  }
  __syncthreads();

  for (long long r0 = r_begin; r0 < r_end; r0 += kBR) {
    rg::load_rows<kThreads>(keys, ks, r0, kBR, r_end, e);
    for (int t = tid; t < kBR; t += kThreads) {
      const long long gr = r0 + t;
      kv[t] = gr < r_end && (valid == nullptr || valid[gr] != 0);
    }
    __syncthreads();

    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    for (int c = 0; c < e; c += 4) {
      float4 a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        a[i] = *reinterpret_cast<const float4*>(qs + (4 * ty + i) * ld + c);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        b[j] = *reinterpret_cast<const float4*>(ks + (tx + 16 * j) * ld + c);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) fma4(acc[i][j], a[i], b[j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        tile[(4 * ty + i) * (kBR + 1) + tx + 16 * j] =
            kv[tx + 16 * j] ? acc[i][j] : kNegInf;
    __syncthreads();

    // Insert this tile's winners, in ascending key order, into the sorted
    // lists of the warp's queries. A new score goes after every equal one,
    // so among ties the lower (earlier) index stays first.
    for (int qq = 0; qq < kBQ / kWarps; ++qq) {
      const int ql = warp * (kBQ / kWarps) + qq;
      if (q0 + ql >= n_q) break;
      float* L = ls + ql * k;
      int* LI = li + ql * k;
      float thr = L[k - 1];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const float sc = tile[ql * (kBR + 1) + half * 32 + lane];
        unsigned m = __ballot_sync(kFull, sc > thr);
        while (m) {
          const int j = __ffs(m) - 1;
          m &= m - 1;
          const float cur = __shfl_sync(kFull, sc, j);
          if (!(cur > thr)) continue;  // the k-th value has risen past it
          const int gidx = (int)(r0 + half * 32 + j);
          int pos = 0;
          float hv[4];
          int hi[4];
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int i = 32 * u + lane;
            const bool in = i < k;
            hv[u] = in ? L[i] : kNegInf;
            hi[u] = in ? LI[i] : 0;
            pos += __popc(__ballot_sync(kFull, in && hv[u] >= cur));
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
            LI[pos] = gidx;
          }
          __syncwarp();
          thr = L[k - 1];
        }
      }
    }
    __syncthreads();
  }

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
__global__ void __launch_bounds__(kThreads)
topk_merge_kernel(const float* __restrict__ part_s,
                  const int* __restrict__ part_i, float* __restrict__ out_s,
                  int* __restrict__ out_i, int n_q, int splits, int k) {
  const int gq = blockIdx.x * kWarps + threadIdx.x / 32;
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

}  // namespace

extern "C" {

// q (Q, E) and keys (R, E) bf16, row-major, E % 8 == 0, E <= 256; valid
// (R,) uint8 or null; 1 <= k <= 128; 1 <= splits <= 32 ranges of
// rows_per_split keys (a multiple of 64). Scratch part_s / part_i hold
// (Q, splits, k); out_s / out_i are (Q, k).
int rg_fused_cosine_topk(const void* q, const void* keys, const void* valid,
                         void* part_s, void* part_i, void* out_s, void* out_i,
                         int n_q, int n_r, int e, int k, int splits,
                         int rows_per_split, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_q == 0) return (int)cudaGetLastError();
  const size_t smem = smem_bytes(e, k);
  cudaError_t err = cudaFuncSetAttribute(
      topk_partial_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((n_q + kBQ - 1) / kBQ, splits);
  topk_partial_kernel<<<grid, kThreads, smem, s>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(keys),
      static_cast<const uint8_t*>(valid), static_cast<float*>(part_s),
      static_cast<int*>(part_i), n_q, n_r, e, k, splits, rows_per_split);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  topk_merge_kernel<<<(n_q + kWarps - 1) / kWarps, kThreads, 0, s>>>(
      static_cast<const float*>(part_s), static_cast<const int*>(part_i),
      static_cast<float*>(out_s), static_cast<int*>(out_i), n_q, splits, k);
  return (int)cudaGetLastError();
}

}  // extern "C"
