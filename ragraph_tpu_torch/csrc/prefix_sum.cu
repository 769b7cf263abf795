// Prefix sum over the rows of an (N, D) matrix (kernel H).
//
// Replaces _cumsum_kernel of ragraph_tpu/ops/pallas_segment.py (reached
// through _cumsum_call by streaming_cumsum, sorted_segment_sum_indptr and
// sorted_segment_sum): the inclusive or exclusive prefix over axis 0 of an
// f32 or bf16 matrix, accumulated and written in f32, plus the (1, D) grand
// total that the segment-sum consumer reads at the position past the end.
//
// What bounds it on an H100: bytes. One add per element against 4 bytes in
// and 4 bytes out; the least traffic is the input read once and the output
// written once (2 * N * D * 4 bytes, 1.07 GB at 2^21 x 64: 0.32 ms at
// 3.35 TB/s).
//
// Design: the TPU kernel walks its row blocks in grid order, carries the
// running row in scratch memory and forms the in-block prefix with a
// triangular-ones matmul, because the matrix unit is the TPU's fast adder
// and its grid is sequential. Here blocks run in parallel and in no order,
// the axis is long and the rows are narrow, so the scan is column-parallel
// over row chunks, in three launches:
//   1. chunk_sums:  one thread per (chunk of kChunk rows, column) adds its
//      rows in order; a warp covers 32 neighbouring columns, so every row
//      step is one coalesced line;
//   2. scan_chunks: per column, the exclusive prefix of the chunk sums
//      (32 threads per column each add a span of the chunks in order, a
//      shared-memory scan joins the spans) and the grand total;
//   3. scan_rows:   the walk of launch 1 again, starting from the chunk's
//      offset and writing the running sum of every row.
// The input is read twice (2.5 passes over the matrix against the bound's
// 2); a single pass with a decoupled look-back would save the second read.
// Additions run in another order than on the TPU (in row order inside a
// chunk, chunk sums in spans), so results agree with it to f32 rounding of
// the prefix, not bitwise. The exclusive prefix is the running sum before
// the row is added, not the TPU's `inclusive - x`. N need not divide the
// chunk: the tail is masked. Offsets are 64-bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 128;      // rows one thread walks
constexpr int kCols = 32;        // columns per block (one warp wide)
constexpr int kChunksPerBlock = 8;
constexpr int kSpans = 32;      // spans of the chunk axis in launch 2
constexpr int kBatch = 8;        // rows loaded before they are added

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__global__ void __launch_bounds__(kCols * kChunksPerBlock)
chunk_sums_kernel(const T* __restrict__ x, float* __restrict__ partial,
                  long long n, int d, long long n_chunks) {
  const int col = blockIdx.y * kCols + threadIdx.x;
  const long long chunk =
      (long long)blockIdx.x * kChunksPerBlock + threadIdx.y;
  if (col >= d || chunk >= n_chunks) return;
  const long long r0 = chunk * kChunk;
  const int rows = (int)min((long long)kChunk, n - r0);
  const T* p = x + r0 * d + col;
  float acc = 0.f;
  int r = 0;
  for (; r + kBatch <= rows; r += kBatch) {
    float v[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j) v[j] = to_f32(p[(long long)(r + j) * d]);
#pragma unroll
    for (int j = 0; j < kBatch; ++j) acc += v[j];
  }
  for (; r < rows; ++r) acc += to_f32(p[(long long)r * d]);
  partial[chunk * d + col] = acc;
}

// One block per 32 columns, kSpans threads per column. Writes the exclusive
// prefix of partial[:, col] to offsets[:, col] and the sum to total[col].
__global__ void __launch_bounds__(kCols * kSpans)
scan_chunks_kernel(const float* __restrict__ partial,
                   float* __restrict__ offsets, float* __restrict__ total,
                   int d, long long n_chunks) {
  __shared__ float span_sum[kSpans][kCols];
  const int col = blockIdx.x * kCols + threadIdx.x;
  const int span = threadIdx.y;
  const long long per = (n_chunks + kSpans - 1) / kSpans;
  const long long c0 = min(n_chunks, span * per);
  const long long c1 = min(n_chunks, c0 + per);
  float acc = 0.f;
  if (col < d) {
#pragma unroll 8
    for (long long c = c0; c < c1; ++c) acc += partial[c * d + col];
  }
  span_sum[span][threadIdx.x] = acc;
  __syncthreads();
  float run = 0.f;
  for (int s = 0; s < span; ++s) run += span_sum[s][threadIdx.x];
  if (col >= d) return;
#pragma unroll 8
  for (long long c = c0; c < c1; ++c) {
    offsets[c * d + col] = run;
    run += partial[c * d + col];
  }
  if (span == kSpans - 1) total[col] = run;
}

template <typename T, bool EXCLUSIVE>
__global__ void __launch_bounds__(kCols * kChunksPerBlock)
scan_rows_kernel(const T* __restrict__ x, const float* __restrict__ offsets,
                 float* __restrict__ out, long long n, int d,
                 long long n_chunks) {
  const int col = blockIdx.y * kCols + threadIdx.x;
  const long long chunk =
      (long long)blockIdx.x * kChunksPerBlock + threadIdx.y;
  if (col >= d || chunk >= n_chunks) return;
  const long long r0 = chunk * kChunk;
  const int rows = (int)min((long long)kChunk, n - r0);
  const T* p = x + r0 * d + col;
  float* o = out + r0 * d + col;
  float run = offsets[chunk * d + col];
  int r = 0;
  for (; r + kBatch <= rows; r += kBatch) {
    float v[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j) v[j] = to_f32(p[(long long)(r + j) * d]);
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      if (EXCLUSIVE) {
        o[(long long)(r + j) * d] = run;
        run += v[j];
      } else {
        run += v[j];
        o[(long long)(r + j) * d] = run;
      }
    }
  }
  for (; r < rows; ++r) {
    const float v = to_f32(p[(long long)r * d]);
    if (EXCLUSIVE) {
      o[(long long)r * d] = run;
      run += v;
    } else {
      run += v;
      o[(long long)r * d] = run;
    }
  }
}

template <typename T>
cudaError_t launch(const T* x, float* out, float* total, float* partial,
                   float* offsets, long long n, int d, bool exclusive,
                   cudaStream_t stream) {
  const long long n_chunks = (n + kChunk - 1) / kChunk;
  const dim3 block(kCols, kChunksPerBlock);
  const dim3 grid((unsigned)((n_chunks + kChunksPerBlock - 1)
                             / kChunksPerBlock),
                  (unsigned)((d + kCols - 1) / kCols));
  chunk_sums_kernel<T><<<grid, block, 0, stream>>>(x, partial, n, d,
                                                   n_chunks);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  scan_chunks_kernel<<<dim3((unsigned)((d + kCols - 1) / kCols)),
                       dim3(kCols, kSpans), 0, stream>>>(
      partial, offsets, total, d, n_chunks);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (exclusive)
    scan_rows_kernel<T, true><<<grid, block, 0, stream>>>(
        x, offsets, out, n, d, n_chunks);
  else
    scan_rows_kernel<T, false><<<grid, block, 0, stream>>>(
        x, offsets, out, n, d, n_chunks);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Rows per chunk: the wrapper sizes `partial` and `offsets` as
// (ceil(n / rg_prefix_sum_chunk()), d) f32 each.
int rg_prefix_sum_chunk() { return kChunk; }

// Kernel H. `x` is (n, d) f32, or bf16 when `bf16_in` is set; n >= 1,
// d >= 1. `out` is (n, d) f32, `total` (1, d) f32.
int rg_prefix_sum(const void* x, void* out, void* total, void* partial,
                  void* offsets, long long n, int d, int exclusive,
                  int bf16_in, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  float* t = static_cast<float*>(total);
  float* pa = static_cast<float*>(partial);
  float* of = static_cast<float*>(offsets);
  if (bf16_in)
    return (int)launch(static_cast<const __nv_bfloat16*>(x), o, t, pa, of, n,
                       d, exclusive != 0, s);
  return (int)launch(static_cast<const float*>(x), o, t, pa, of, n, d,
                     exclusive != 0, s);
}

}  // extern "C"
