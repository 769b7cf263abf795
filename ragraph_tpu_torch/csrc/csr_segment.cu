// CSR segment sums for the LightGCN propagation (kernels A and B).
//
// Replaces these kernels of ragraph_tpu/ops/pallas_segment.py:
//   A: _packed_scan_w_kernel (via sorted_segment_sum_packed_w and
//      gather_scale_segsum), together with the XLA row gather `table[idx]`
//      and the prefix-difference lookup `_packed_boundary`;
//   B: _packed_scan_kernel (via sorted_segment_sum_packed and
//      sorted_segment_sum_grad), together with `_packed_boundary`.
//
// Computes  out[r] = sum_{e in [indptr[r], indptr[r+1])} w[e] * table[idx[e]]
// (A), or   out[r] = sum_{e in [indptr[r], indptr[r+1])} msgs[e]   (B),
// accumulated in f32. With a bf16 table, A also rounds w to bf16, so each
// product is exact in f32 as in the TPU kernel's bf16 matmul.
//
// What bounds it on an H100: bytes. Per output row the work is one multiply-
// add per gathered element, far below the 295 operations per byte at which
// the tensor cores would be the limit. The least traffic is each input read
// once and the output written once (for A at 2^21 edges x 64: ~152 MB, about
// 0.045 ms at 3.35 TB/s); the row gathers touch E*D elements, which at the
// main-path shape is a 33.5 MB bf16 table that fits in the 50 MB L2.
//
// Design: the TPU kernel formed a prefix sum with triangular MXU matmuls and
// took differences at the segment bounds, because the TPU has no fast
// scatter. On the GPU the CSR form needs neither: one warp owns one output
// row, its lanes own consecutive pairs of columns (8-byte f32 or 4-byte bf16
// loads, so a 64-wide row is one coalesced access per edge), and it walks the
// row's edges in order. The warp loads 32 edge ids and weights at once and
// broadcasts them with shuffles. Sums are taken directly, in edge order:
// deterministic, no atomics, and without the cancellation error of the
// prefix difference. Element offsets are 64-bit, since E*D passes 2^31 at
// 100M edges.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;           // rows per block
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float2 load_pair(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

__device__ __forceinline__ float2 load_pair(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// CH = number of 64-column chunks a lane covers (d <= 64 * CH).
// GATHER: rows come from src[idx[e]] scaled by w[e] (A); otherwise from
// src[e] unscaled (B). T is the element type of src.
template <int CH, bool GATHER, typename T>
__global__ void __launch_bounds__(kWarps * 32)
csr_rows_kernel(const T* __restrict__ src, const float* __restrict__ w,
                const int* __restrict__ idx, const int* __restrict__ indptr,
                float* __restrict__ out, long long n_rows, int d,
                bool round_w) {
  const long long row = (long long)blockIdx.x * kWarps + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (row >= n_rows) return;
  const int start = indptr[row];
  const int end = indptr[row + 1];

  float2 acc[CH];
#pragma unroll
  for (int c = 0; c < CH; ++c) acc[c] = make_float2(0.f, 0.f);

  for (int base = start; base < end; base += 32) {
    const int e = base + lane;
    int my_src = 0;
    float my_w = 0.f;
    if (e < end) {
      my_src = GATHER ? idx[e] : e;
      if (GATHER) my_w = round_w ? round_bf16(w[e]) : w[e];
    }
    const int cnt = min(32, end - base);
#pragma unroll 4
    for (int j = 0; j < cnt; ++j) {
      const int s = __shfl_sync(kFull, my_src, j);
      const float ww = GATHER ? __shfl_sync(kFull, my_w, j) : 1.f;
      const T* rowp = src + (long long)s * d;
#pragma unroll
      for (int c = 0; c < CH; ++c) {
        const int col = 2 * (lane + 32 * c);
        if (col < d) {
          const float2 x = load_pair(rowp + col);
          if (GATHER) {
            acc[c].x = fmaf(ww, x.x, acc[c].x);
            acc[c].y = fmaf(ww, x.y, acc[c].y);
          } else {
            acc[c].x += x.x;
            acc[c].y += x.y;
          }
        }
      }
    }
  }
  float* orow = out + row * (long long)d;
#pragma unroll
  for (int c = 0; c < CH; ++c) {
    const int col = 2 * (lane + 32 * c);
    if (col < d) *reinterpret_cast<float2*>(orow + col) = acc[c];
  }
}

template <bool GATHER, typename T>
cudaError_t launch(const T* src, const float* w, const int* idx,
                   const int* indptr, float* out, long long n_rows, int d,
                   bool round_w, cudaStream_t stream) {
  if (n_rows == 0) return cudaGetLastError();
  const dim3 grid((unsigned)((n_rows + kWarps - 1) / kWarps));
  const dim3 block(kWarps * 32);
  const int ch = (d + 63) / 64;
  switch (ch) {
    case 1: csr_rows_kernel<1, GATHER, T><<<grid, block, 0, stream>>>(
        src, w, idx, indptr, out, n_rows, d, round_w); break;
    case 2: csr_rows_kernel<2, GATHER, T><<<grid, block, 0, stream>>>(
        src, w, idx, indptr, out, n_rows, d, round_w); break;
    case 3: case 4: csr_rows_kernel<4, GATHER, T><<<grid, block, 0, stream>>>(
        src, w, idx, indptr, out, n_rows, d, round_w); break;
    default: csr_rows_kernel<8, GATHER, T><<<grid, block, 0, stream>>>(
        src, w, idx, indptr, out, n_rows, d, round_w); break;
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Kernel A. `table` is (N, d) f32, or bf16 when `bf16_table` is set (then w
// is rounded to bf16 too); d even, d <= 512. out is (n_rows, d) f32.
int rg_csr_gather_scale_segsum(const void* table, const void* w,
                               const void* idx, const void* indptr, void* out,
                               long long n_rows, int d, int bf16_table,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16_table)
    return (int)launch<true>(static_cast<const __nv_bfloat16*>(table),
                             static_cast<const float*>(w),
                             static_cast<const int*>(idx),
                             static_cast<const int*>(indptr),
                             static_cast<float*>(out), n_rows, d, true, s);
  return (int)launch<true>(static_cast<const float*>(table),
                           static_cast<const float*>(w),
                           static_cast<const int*>(idx),
                           static_cast<const int*>(indptr),
                           static_cast<float*>(out), n_rows, d, false, s);
}

// Kernel B. `msgs` is (E, d) f32 with rows grouped by segment; d even,
// d <= 512. out is (n_rows, d) f32.
int rg_csr_segment_sum(const void* msgs, const void* indptr, void* out,
                       long long n_rows, int d, void* stream) {
  return (int)launch<false>(static_cast<const float*>(msgs), nullptr, nullptr,
                            static_cast<const int*>(indptr),
                            static_cast<float*>(out), n_rows, d, false,
                            static_cast<cudaStream_t>(stream));
}

const char* rg_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
