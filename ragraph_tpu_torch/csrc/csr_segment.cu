// CSR segment sums for the LightGCN propagation (kernels A, B and I).
//
// Replaces these kernels of ragraph_tpu/ops/pallas_segment.py:
//   A: _packed_scan_w_kernel (via sorted_segment_sum_packed_w and
//      gather_scale_segsum), together with the XLA row gather `table[idx]`
//      and the prefix-difference lookup `_packed_boundary`;
//   B: _packed_scan_kernel (via sorted_segment_sum_packed and
//      sorted_segment_sum_grad), together with `_packed_boundary`;
//   I: _packed_scan_w_kernel with packed_input (via _segsum_packed2_w),
//      together with `_packed_boundary`.
//
// Computes  out[r] = sum_{e in [indptr[r], indptr[r+1])} w[e] * table[idx[e]]
// (A), or   out[r] = sum_{e in [indptr[r], indptr[r+1])} msgs[e]   (B),
// or        out[r] = sum_{e in [indptr[r], indptr[r+1])} w[e] * msg(e)  (I),
// accumulated in f32. For I the message of edge e lies in a half-split
// packed (n/2, 2d) matrix: packed row (e / 2B) * B + e % B, half
// (e / B) % 2, which read as an (n, d) matrix is row 2 * packed row + half:
// an address computed from e, so I is a walk with no index array. With
// bf16 rows, A and I also round w to bf16, so each product is exact in f32
// as in the TPU kernel's bf16 matmul.
//
// What bounds them on an H100: bytes. Per output row the work is one
// multiply-add per gathered element, far below the 295 operations per byte
// at which the tensor cores would be the limit. The bound counts each input
// read once and the output written once: for A at 2^21 edges x 64 (the f32
// table the wrapper is handed, ids, weights, indptr, the f32 output) ~152 MB,
// about 0.045 ms at 3.35 TB/s. The gathers read more than that, from L2:
// 2^21 rows of 128 bytes, 268 MB, from a 33.5 MB bf16 table that fits in the
// 50 MB L2. So A is held by L2 bandwidth and by the latency of its
// dependent loads (indptr, then ids, then rows), not by device memory.
//
// A runs the row walk of rg_csr.cuh, which kernel K shares: groups of 8
// lanes a 64-wide bf16 row, one 16-byte load a lane and edge, 8 short rows a
// group walked as one stream of batches whose next ids load before this
// batch's rows, 4 row loads a lane in flight, 4 blocks of 256 threads an SM;
// rows of more than hub_edges edges cut into pieces, whose partial sums add
// in a fixed order.
//
// B and I walk one warp per output row: its lanes own consecutive pairs of
// columns (8-byte f32 or 4-byte bf16 loads, so a 64-wide row is one
// coalesced access per edge), and it walks the row's edges in order, 32 at a
// time, handing each edge's row address to the lanes with shuffles. All sums
// are taken directly, in edge order: deterministic, no atomics, and without
// the cancellation error of the prefix difference. Element offsets are
// 64-bit, since E*D passes 2^31 at 100M edges. An odd width takes one column
// a load; a row wider than 512 columns (256 when odd) is summed in column
// slices of that width, a launch each.
//
// A's walk takes any width the same way (rg_csr.cuh: one column a chunk for
// an odd width, column slices of 512 columns or 256 chunks).

#include "rg_csr.cuh"

namespace {

constexpr int kWarps = 8;           // rows per block
constexpr unsigned kFull = 0xffffffffu;

using rgc::round_bf16;

// V = 2 columns (an even width: 8-byte f32 or 4-byte bf16 loads), or 1 (an
// odd width) at p; a lone column in .x.
template <int V>
__device__ __forceinline__ float2 load_cols(const float* p) {
  if (V == 1) return make_float2(*p, 0.f);
  return *reinterpret_cast<const float2*>(p);
}

template <int V>
__device__ __forceinline__ float2 load_cols(const __nv_bfloat16* p) {
  if (V == 1) return make_float2(__bfloat162float(*p), 0.f);
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// Where the row of edge e comes from.
constexpr int kPlain = 0;   // B: src[e], unscaled
constexpr int kPacked = 1;  // I: e's half-split packed row, scaled by w[e]

// A lane covers CH chunks of V columns each, columns V * (lane + 32 c), of a
// slice of dc <= 32 * V * CH columns; src and out point at the slice's first
// column and rows are d apart. T is the element type of src. `pack_block` is
// I's B (rows per packed half).
template <int CH, int V, int MODE, typename T>
__global__ void __launch_bounds__(kWarps * 32)
csr_rows_kernel(const T* __restrict__ src, const float* __restrict__ w,
                const int* __restrict__ indptr,
                float* __restrict__ out, long long n_rows, int d, int dc,
                bool round_w, int pack_block) {
  constexpr bool SCALE = MODE != kPlain;
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
      if (MODE == kPacked) {
        const int b = pack_block;
        my_src = 2 * ((e / (2 * b)) * b + e % b) + (e / b) % 2;
      } else {
        my_src = e;
      }
      if (SCALE) my_w = round_w ? round_bf16(w[e]) : w[e];
    }
    const int cnt = min(32, end - base);
#pragma unroll 4
    for (int j = 0; j < cnt; ++j) {
      const int s = __shfl_sync(kFull, my_src, j);
      const float ww = SCALE ? __shfl_sync(kFull, my_w, j) : 1.f;
      const T* rowp = src + (long long)s * d;
#pragma unroll
      for (int c = 0; c < CH; ++c) {
        const int col = V * (lane + 32 * c);
        if (col < dc) {
          float2 x = load_cols<V>(rowp + col);
          if (MODE == kPacked && sizeof(T) == 4 && round_w) {
            x.x = round_bf16(x.x);   // f32 rows under the bf16 switch
            x.y = round_bf16(x.y);
          }
          if (SCALE) {
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
    const int col = V * (lane + 32 * c);
    if (col < dc) {
      if (V == 1)
        orow[col] = acc[c].x;
      else
        *reinterpret_cast<float2*>(orow + col) = acc[c];
    }
  }
}

// One launch for a slice of dc columns from column c0.
template <int V, int MODE, typename T>
void launch_cols(const T* src, const float* w, const int* indptr,
                  float* out, long long n_rows, int d, int c0, int dc,
                  bool round_w, cudaStream_t stream, int pack_block) {
  const dim3 grid((unsigned)((n_rows + kWarps - 1) / kWarps));
  const dim3 block(kWarps * 32);
  src += c0;
  out += c0;
  switch ((dc + 32 * V - 1) / (32 * V)) {
    case 1: csr_rows_kernel<1, V, MODE, T><<<grid, block, 0, stream>>>(
        src, w, indptr, out, n_rows, d, dc, round_w, pack_block); break;
    case 2: csr_rows_kernel<2, V, MODE, T><<<grid, block, 0, stream>>>(
        src, w, indptr, out, n_rows, d, dc, round_w, pack_block); break;
    case 3: case 4: csr_rows_kernel<4, V, MODE, T><<<grid, block, 0,
                                                    stream>>>(
        src, w, indptr, out, n_rows, d, dc, round_w, pack_block); break;
    default: csr_rows_kernel<8, V, MODE, T><<<grid, block, 0, stream>>>(
        src, w, indptr, out, n_rows, d, dc, round_w, pack_block); break;
  }
}

// Rows of d columns: column slices of 256 V columns (512 for an even d, 256
// for an odd one), one launch each.
template <int MODE, typename T>
cudaError_t launch(const T* src, const float* w, const int* indptr,
                   float* out, long long n_rows, int d,
                   bool round_w, cudaStream_t stream, int pack_block = 0) {
  if (n_rows == 0) return cudaGetLastError();
  if (d < 1) return cudaErrorInvalidValue;
  const int slice = d % 2 == 0 ? 512 : 256;
  for (int c0 = 0; c0 < d; c0 += slice) {
    const int dc = d - c0 < slice ? d - c0 : slice;
    if (d % 2 == 0)
      launch_cols<2, MODE, T>(src, w, indptr, out, n_rows, d, c0, dc,
                               round_w, stream, pack_block);
    else
      launch_cols<1, MODE, T>(src, w, indptr, out, n_rows, d, c0, dc,
                               round_w, stream, pack_block);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace

extern "C" {

// Kernel A. table (N, d): bf16 when bf16_table, and then w (E,) f32 is
// rounded to bf16 too, else f32; idx (E,) int32; indptr (n_rows + 1,) int32;
// any d >= 1. The walk plan (hub_edges ... n_pieces) is
// ops/csr_segment.py::walk_plan(indptr); partial is (n_pieces, d) f32
// scratch. out is (n_rows, d) f32.
int rg_csr_gather_scale_segsum(const void* table, const void* w,
                               const void* idx, const void* indptr, void* out,
                               long long n_rows, int d, int bf16_table,
                               int hub_edges, const void* long_rows,
                               const void* piece_ptr, long long n_long,
                               const void* pieces, long long n_pieces,
                               void* partial, void* stream) {
  const rgc::Plan plan = rgc::make_plan(hub_edges, long_rows, piece_ptr,
                                        n_long, pieces, n_pieces, partial);
  const char* t = static_cast<const char*>(table);
  const int* ix = static_cast<const int*>(idx);
  const float* ww = static_cast<const float*>(w);
  const int* ip = static_cast<const int*>(indptr);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long rb = (long long)d * (bf16_table ? 2 : 4);  // row bytes
  if (d < 1) return (int)cudaErrorInvalidValue;
  if (bf16_table) {
    if (rb % 16 == 0)
      return (int)rgc::launch_walk(
          rgc::TableRows<__nv_bfloat16, 16>{t, rb, ix, ww, true}, ip, o,
          n_rows, d, (int)(rb / 16), plan, s);
    if (d % 2 == 0)
      return (int)rgc::launch_walk(
          rgc::TableRows<__nv_bfloat16, 4>{t, rb, ix, ww, true}, ip, o,
          n_rows, d, (int)(rb / 4), plan, s);
    return (int)rgc::launch_walk(
        rgc::TableRows<__nv_bfloat16, 2>{t, rb, ix, ww, true}, ip, o, n_rows,
        d, d, plan, s);
  }
  if (rb % 16 == 0)
    return (int)rgc::launch_walk(rgc::TableRows<float, 16>{
        t, rb, ix, ww, false}, ip, o, n_rows, d, (int)(rb / 16), plan, s);
  if (d % 2 == 0)
    return (int)rgc::launch_walk(rgc::TableRows<float, 8>{
        t, rb, ix, ww, false}, ip, o, n_rows, d, (int)(rb / 8), plan, s);
  return (int)rgc::launch_walk(rgc::TableRows<float, 4>{
      t, rb, ix, ww, false}, ip, o, n_rows, d, d, plan, s);
}

// Kernel B. `msgs` is (E, d) f32 with rows grouped by segment; any d >= 1.
// out is (n_rows, d) f32.
int rg_csr_segment_sum(const void* msgs, const void* indptr, void* out,
                       long long n_rows, int d, void* stream) {
  return (int)launch<kPlain>(static_cast<const float*>(msgs), nullptr,
                            static_cast<const int*>(indptr),
                            static_cast<float*>(out), n_rows, d, false,
                            static_cast<cudaStream_t>(stream));
}

// Kernel I. `msgs2` is (n / 2, 2d) in the half-split layout with `block`
// rows per half, f32 or (with `bf16_rows`) bf16; n is a multiple of
// 2 * block; any d >= 1. With `round_to_bf16`, rows and weights are
// rounded to bf16 before the f32 multiply-add. w is (n,) f32, out is
// (n_rows, d) f32.
int rg_csr_segsum_packed2_w(const void* msgs2, const void* w,
                            const void* indptr, void* out, long long n_rows,
                            int d, int block, int bf16_rows,
                            int round_to_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16_rows)
    return (int)launch<kPacked>(static_cast<const __nv_bfloat16*>(msgs2),
                                static_cast<const float*>(w),
                                static_cast<const int*>(indptr),
                                static_cast<float*>(out), n_rows, d,
                                round_to_bf16 != 0, s, block);
  return (int)launch<kPacked>(static_cast<const float*>(msgs2),
                              static_cast<const float*>(w),
                              static_cast<const int*>(indptr),
                              static_cast<float*>(out), n_rows, d,
                              round_to_bf16 != 0, s, block);
}

const char* rg_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
