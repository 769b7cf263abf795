// The selection family: an exact top-k of each row for any k. It takes
// every k above 128 for kernels C, E and G, whose lists hold at most 128
// entries (fused_retrieval.cu's shared-memory lists, rg_topk.cuh's warp
// lists); ops/select_topk.py routes to it.
//
// Replaces, for k > 128, what these kernels of the TPU package compute:
// ragraph_tpu/ops/pallas_retrieval.py::_kernel (C: its scores come from
// bucket_topk.cu's rg_score_matrix, the tensor-core tile of D, F and C, so
// they are bit for bit kernel C's), ragraph_tpu/ops/bucket_topk.py::
// _col_topk_kernel (E, on the transposed bucket maxima) and
// _row_topk_kernel (G).
//
// One block a row (rg_select.cuh): a radix select of the k-th largest
// value, a compaction of the k members (ties by ascending index), a
// bitonic sort of the members (value descending, index ascending) in
// shared memory, or, for more than kSmemSort members, in a global scratch
// row of the block's own. A slot whose value is not above -3e38 (a masked
// key, an exhausted row) and a slot past the row's n values hold
// (-3e38, 0), as the other kernels' exhausted slots do.
//
// What bounds it on an H100: bytes. At the main path's refresh chunk
// (2,048 rows of 262,144 scores, k = 1,000) the rows are 2.1 GB read five
// times (four histogram passes and the compaction); the sort touches
// k log^2 k words a row in shared memory.

#include "rg_select.cuh"
#include "rg_tile.cuh"

namespace {

constexpr int kSmemSort = 16384;  // members sorted in shared memory (128 KB)

template <bool kSmem>
__global__ void __launch_bounds__(rgs::kThreads)
select_topk_kernel(const float* __restrict__ x, long long ld, int n, int k,
                   int p, uint64_t* __restrict__ scratch,
                   float* __restrict__ out_v, int* __restrict__ out_i) {
  __shared__ rgs::Scratch sc;
  extern __shared__ uint64_t dyn[];
  const long long row = blockIdx.x;
  const float* xr = x + row * ld;
  uint64_t* buf = kSmem ? dyn : scratch + row * p;
  const int m = min(k, n);  // members
  if (n <= k) {
    for (int i = threadIdx.x; i < n; i += rgs::kThreads)
      buf[i] = rgs::member(rgs::order_key(__ldg(xr + i)), i);
  } else {
    int ties;
    const uint32_t kth = rgs::radix_select(xr, n, k, sc, ties);
    rgs::compact(xr, n, k, kth, ties, sc, buf);
  }
  for (int i = m + threadIdx.x; i < p; i += rgs::kThreads) buf[i] = 0;
  __syncthreads();
  rgs::bitonic_sort(buf, p);
  for (int i = threadIdx.x; i < k; i += rgs::kThreads) {
    float v = rg::kNegInf;
    int idx = 0;
    if (i < m) {
      const uint64_t w = buf[i];
      const float f = rgs::from_order_key((uint32_t)(w >> 32));
      if (f > rg::kNegInf) {
        v = f;
        idx = (int)~(uint32_t)w;
      }
    }
    out_v[row * k + i] = v;
    out_i[row * k + i] = idx;
  }
}

}  // namespace

extern "C" {

// x (n_rows, n) f32 with row stride ld >= n; 1 <= n, 1 <= k; p the least
// power of two >= min(k, n). out_v / out_i are (n_rows, k): each row's k
// largest values, descending, ties to the lowest column, (-3e38, 0) in a
// slot whose value is not above -3e38 and past n. scratch is null when
// p <= 16,384 (the sort runs in shared memory), else (n_rows, p) uint64.
int rg_select_topk(const void* x, long long ld, int n_rows, int n, int k,
                   int p, void* scratch, void* out_v, void* out_i,
                   void* stream) {
  if (n_rows == 0) return (int)cudaGetLastError();
  const int m = n < k ? n : k;
  if (n < 1 || k < 1 || ld < n || p < m || p / 2 >= m || (p & (p - 1)) ||
      (p > kSmemSort && scratch == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* xf = static_cast<const float*>(x);
  auto* sw = static_cast<uint64_t*>(scratch);
  auto* ov = static_cast<float*>(out_v);
  auto* oi = static_cast<int*>(out_i);
  if (p <= kSmemSort) {
    const size_t smem = sizeof(uint64_t) * (size_t)p;
    cudaError_t err = cudaFuncSetAttribute(
        select_topk_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    select_topk_kernel<true><<<n_rows, rgs::kThreads, smem, s>>>(
        xf, ld, n, k, p, nullptr, ov, oi);
  } else {
    select_topk_kernel<false><<<n_rows, rgs::kThreads, 0, s>>>(
        xf, ld, n, k, p, sw, ov, oi);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
