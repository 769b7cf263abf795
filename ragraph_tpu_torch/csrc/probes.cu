// The three probe kernels of the bench scripts (kernels J, K, L).
//
// They replace the Pallas kernels that live outside the ragraph_tpu package,
// in its benchmark and experiment scripts:
//   J  rg_mm_probe             benchmarks/bench_exact_phases.py::_mm_kernel
//                              the full keys x queries product of which one
//                              row of every 128-row group is written: phase 1
//                              of the bucket top-k without the group maximum
//   K  rg_packed_table_segsum  experiments/packed_table_gather_bench.py::
//                              _pt_scan_kernel (with _packed_boundary and the
//                              XLA gather `table_packed[idx_half]`): a weighted
//                              segment sum from a table packed two rows to one
//   L  rg_onehot_gather        experiments/onehot_gather_bench.py::
//                              onehot_gather_kernel: a block-local row gather
//
// None is carried over block by block. The TPU versions feed the MXU: K forms
// a prefix sum with two column-scaled strict triangles and L selects rows by a
// one-hot matmul, because the TPU has no fast scatter or dynamic row
// addressing. A GPU has both.
//
// What bounds each on an H100, at the scripts' shapes:
//   J  operations: 2*R*Q*E = 137 GFLOP at R = 262,144, Q = 2,048, E = 128
//      (0.14 ms at the bf16 tensor-core rate) against 67.6 MB of input and a
//      16.8 MB result. It runs kernel C's tensor-core score tile (rg_mma.cuh)
//      with the keys on the 64-row side: a block holds 128 queries resident
//      and walks a range of 128-key groups, one warpgroup per half group,
//      the next group's cp.async copies in flight while the current one
//      multiplies. The written row is a runtime argument: the threads that
//      hold it write it straight from the accumulators, and every product of
//      the group has been taken by then, so the probe times the whole tile.
//      Its sums are the tensor cores' order, within a few f32 roundings of
//      kernel F's score of key 128*g + pick_row.
//   K  bytes: 8.4 MB of indices, 16.8 MB of weights, a 33.5 MB table and a
//      67 MB result at N = 2^18, D = 64, 2^21 edges (the bound, 127 MB, 0.038
//      ms at 3.35 TB/s). The gathers read more, from L2: 2^21 packed rows of
//      256 bytes, 537 MB, from a table that fits in the 50 MB L2, so L2
//      bandwidth and load latency hold K, not device memory. K is kernel A's
//      row walk (rg_csr.cuh, PackedRows): groups of 8 lanes a 64-wide row,
//      each lane a 16-byte load from the low and from the high half of an
//      edge's packed row, 2 edges' rows a lane in flight, 8 short rows a
//      group walked as one stream of batches whose next ids load before this
//      batch's rows; rows of more than hub_edges edges cut into pieces,
//      summed in a fixed order. Every edge adds the low
//      half's product and then the high half's into one f32 sum, in edge
//      order, so with the parity split K equals kernel A to the bit.
//   L  bytes: the padded stream written (2,048 * P * 128 B, at least 268 MB),
//      a 33.5 MB table and the columns read. One block per table block holds
//      its 128 rows in shared memory and copies 16 bytes a thread.

#include "rg_csr.cuh"
#include "rg_mma.cuh"
#include "rg_tile.cuh"

namespace {

constexpr int kLane = 128;     // rows per group (J) and per table block (L)
constexpr int kJThreads = 2 * 128;  // J: a warpgroup per 64 keys of a group
constexpr int kGroupsPerBlock = 16;  // J: groups one block walks over
constexpr int kThreads = 256;  // L

// ---- J ---------------------------------------------------------------------

__global__ void __launch_bounds__(kJThreads)
mm_probe_kernel(const __nv_bfloat16* __restrict__ keys,
                const __nv_bfloat16* __restrict__ q, float* __restrict__ out,
                int n_r, int n_q, int e, int n_groups, int pick_row) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = rgm::aligned_smem(smem_raw);
  const size_t tile = rgm::tile_bytes(kLane, e);  // 128 rows, either side
  const uint32_t qs = rgm::smem_addr(smem);
  const uint32_t stage[2] = {qs + (uint32_t)tile, qs + (uint32_t)(2 * tile)};

  const int q0 = blockIdx.x * rgm::kTileN;
  const int g_begin = blockIdx.y * kGroupsPerBlock;
  const int g_end = min(n_groups, g_begin + kGroupsPerBlock);
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid & 31;
  // the thread that holds the written row: warpgroup, warp, lane / 4, and
  // which of its two accumulator rows
  const bool writer = warp == pick_row / 16 && (lane >> 2) == pick_row % 8;
  const bool upper = (pick_row % 16) >= 8;

  rgm::load_tile<kJThreads>(q, qs, q0, rgm::kTileN, n_q, e);
  rgm::load_tile<kJThreads>(keys, stage[0], (long long)g_begin * kLane, kLane,
                            n_r, e);
  rgm::cp_async_commit();
  for (int g = g_begin; g < g_end; ++g) {
    const int t = g - g_begin;
    // group g has landed, and both warpgroups are done with group g - 1,
    // whose stage takes group g + 1 while group g multiplies
    rgm::cp_async_wait<0>();
    __syncthreads();
    if (g + 1 < g_end) {
      rgm::load_tile<kJThreads>(keys, stage[(t + 1) & 1],
                                (long long)(g + 1) * kLane, kLane, n_r, e);
      rgm::cp_async_commit();
    }

    float acc[rgm::kAcc];
    rgm::mma_tile(acc, stage[t & 1], kLane, rgm::kTileM * (warp / 4), qs, e);
    if (writer) {
      float* row = out + (long long)g * n_q;
#pragma unroll
      for (int j = 0; j < rgm::kAcc / 4; ++j) {
        const int gq = q0 + 8 * j + 2 * (lane & 3);
        const float a = upper ? acc[4 * j + 2] : acc[4 * j];
        const float b = upper ? acc[4 * j + 3] : acc[4 * j + 1];
        if (gq < n_q) row[gq] = a;
        if (gq + 1 < n_q) row[gq + 1] = b;
      }
    }
  }
}

// ---- L ---------------------------------------------------------------------

// One block per table block of 128 rows; a row is `chunks` 16-byte pieces.
__global__ void __launch_bounds__(kThreads)
onehot_gather_kernel(const int* __restrict__ col,
                     const uint4* __restrict__ table, uint4* __restrict__ out,
                     int p, long long n_rows, int chunks) {
  extern __shared__ __align__(16) uint4 tab[];  // (128, chunks)
  const long long b = blockIdx.x;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  for (int t = threadIdx.x; t < kLane * chunks; t += kThreads) {
    const long long gr = b * kLane + t / chunks;
    tab[t] = gr < n_rows ? table[b * kLane * chunks + t] : zero;
  }
  __syncthreads();
  const int* cols = col + b * p;
  uint4* dst = out + b * p * chunks;
  for (int u = threadIdx.x; u < p * chunks; u += kThreads) {
    const int s = u / chunks;
    const int c = u - s * chunks;
    const int cv = cols[s];
    dst[u] = (unsigned)cv < (unsigned)kLane ? tab[cv * chunks + c] : zero;
  }
}

cudaError_t allow_smem(const void* kernel, size_t bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace

extern "C" {

// Kernel J. keys (R, E) and q (Q, E) bf16, row-major, E % 8 == 0, E <= 256;
// 0 <= pick_row < 128. out is (ceil(R / 128), Q) f32:
// out[g, j] = keys[128 * g + pick_row] . q[j], 0 where that row is past R.
int rg_mm_probe(const void* keys, const void* q, void* out, int n_r, int n_q,
                int e, int pick_row, void* stream) {
  if (n_r == 0 || n_q == 0) return (int)cudaGetLastError();
  const int n_groups = (n_r + kLane - 1) / kLane;
  const size_t smem = rgm::kAlign + 3 * rgm::tile_bytes(kLane, e);
  cudaError_t err = allow_smem((const void*)mm_probe_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((n_q + rgm::kTileN - 1) / rgm::kTileN,
                  (n_groups + kGroupsPerBlock - 1) / kGroupsPerBlock);
  mm_probe_kernel<<<grid, kJThreads, smem,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(keys),
      static_cast<const __nv_bfloat16*>(q), static_cast<float*>(out), n_r,
      n_q, e, n_groups, pick_row);
  return (int)cudaGetLastError();
}

// Kernel K. table (M, 2d) bf16: packed row m holds [row 2m | row 2m + 1] of
// the (2M, d) table; idx_half (E,) int32 packed rows; w_lo, w_hi (E,) f32,
// rounded to bf16 here; indptr (n_rows + 1,) int32 over the receiver-sorted
// edges; d even, d <= 128. The walk plan (hub_edges ... n_pieces) is
// ops/csr_segment.py::walk_plan(indptr); partial is (n_pieces, d) f32
// scratch. out is (n_rows, d) f32:
// out[r] = sum_e w_lo[e] * table[idx_half[e], :d] + w_hi[e] * table[.., d:].
int rg_packed_table_segsum(const void* table, const void* w_lo,
                           const void* w_hi, const void* idx_half,
                           const void* indptr, void* out, long long n_rows,
                           int d, int hub_edges, const void* long_rows,
                           const void* piece_ptr, long long n_long,
                           const void* pieces, long long n_pieces,
                           void* partial, void* stream) {
  const rgc::Plan plan = rgc::make_plan(hub_edges, long_rows, piece_ptr,
                                        n_long, pieces, n_pieces, partial);
  const char* t = static_cast<const char*>(table);
  const int* ix = static_cast<const int*>(idx_half);
  const float* wl = static_cast<const float*>(w_lo);
  const float* wh = static_cast<const float*>(w_hi);
  const int* ip = static_cast<const int*>(indptr);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long half = 2LL * d;  // bytes of a half row
  if (half % 16 == 0)
    return (int)rgc::launch_walk(
        rgc::PackedRows<16>{t, 2 * half, half, ix, wl, wh}, ip, o, n_rows, d,
        (int)(half / 16), plan, s);
  return (int)rgc::launch_walk(rgc::PackedRows<4>{t, 2 * half, half, ix, wl,
                                                  wh},
                               ip, o, n_rows, d, (int)(half / 4), plan, s);
}

// Kernel L. col (nb, p) int32 block-local rows; table (n_rows, d) bf16 with
// ceil(n_rows / 128) == nb, d % 8 == 0, d <= 512. out is (nb * p, d) bf16:
// out[b * p + s] = table[128 * b + col[b, s]], a zero row where col[b, s] is
// outside [0, 128) or that table row is past n_rows.
int rg_onehot_gather(const void* col, const void* table, void* out, int nb,
                     int p, long long n_rows, int d, void* stream) {
  if (nb == 0 || p == 0) return (int)cudaGetLastError();
  const int chunks = d / 8;
  const size_t smem = sizeof(uint4) * kLane * (size_t)chunks;
  cudaError_t err = allow_smem((const void*)onehot_gather_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  onehot_gather_kernel<<<nb, kThreads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(col), static_cast<const uint4*>(table),
      static_cast<uint4*>(out), p, n_rows, chunks);
  return (int)cudaGetLastError();
}

}  // extern "C"
