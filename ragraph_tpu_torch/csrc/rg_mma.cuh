// The tensor-core score tile of kernels C, D, F and J (fused_retrieval.cu,
// bucket_topk.cu, probes.cu): a 64 x 128 block of dot products of bf16 rows,
// summed in f32 by Hopper's warpgroup matrix multiply.
//
// One warpgroup (128 threads) issues wgmma.mma_async.m64n128k16 with both
// operands in shared memory: A is 64 rows of one tile, B the 128 rows of
// another, both K-major (a row's E values are contiguous). Products of bf16
// values are exact in f32; the tensor cores add them in their own order, so
// a score differs from a sequential f32 sum (the plain versions in ops/) by
// a few f32 roundings of a sum of at most 256 terms. The order depends only
// on the k16 steps taken, not on where the two rows sit in their tiles:
// kernels D and F put the query on A and the key on B, take the same
// steps, and so give bitwise the same score for the same pair.
//
// Layout. A tile of `rows` rows stays bf16 in shared memory, in 128-byte
// swizzle atoms: the columns are padded with zeros to a multiple of 16 (the
// k16 step; a zero product adds exactly 0) and cut into atoms of 64
// columns; atom a holds every row's columns 64a..64a+63 at offset
// a * rows * 128, row r at r * 128 inside it, and the 16-byte chunk c of
// the row at (c ^ (r % 8)) * 16. That is the hardware's 128-byte swizzle,
// which spreads the eight rows of a core matrix over all 32 banks. Tiles
// start on a 1024-byte boundary, as the swizzle requires.
//
// Loads are cp.async copies of 16 bytes that zero-fill what lies past the
// source's rows or width, so the kernels stage the next key tile while the
// current one multiplies. The sources are rows of a multiple of 8 values
// (the wrappers pad a narrower row with zero columns, which add exactly 0).
//
// Wide rows. A row of at most kResidentE values stays whole in one tile.
// A wider one is walked in chunks of kChunkE columns, chunk after chunk
// into the same accumulators, each chunk a tile pair of its own. mma_row
// takes those steps for every kernel (C, D, F and the score matrix), so
// the score of a pair is the same sequence of k16 steps in all of them (D
// and F stay bitwise equal, and C's scores are the score matrix's);
// TileWalk is the two-stage ring of key tiles that D and the score matrix
// share (kernel C stages its tiles by TMA, in fused_retrieval.cu, and
// takes the same k16 steps in the same order).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace rgm {

constexpr int kTileM = 64;    // A rows per warpgroup
constexpr int kTileN = 128;   // B rows per tile
constexpr int kAcc = 64;      // f32 accumulators per thread (64 * 128 / 128)
constexpr int kAlign = 1024;  // swizzle-atom alignment of a tile

constexpr int kResidentE = 256;  // widest row kept whole in a tile
constexpr int kChunkE = 128;     // columns of a chunk of a wider row

// E rounded up to the k16 step.
__host__ __device__ inline int padded_width(int e) {
  return (e + 15) / 16 * 16;
}

// Whether rows of e values are walked in chunks of kChunkE, and how many.
__host__ __device__ inline bool chunked(int e) { return e > kResidentE; }
__host__ __device__ inline int n_chunks(int e) {
  return chunked(e) ? (e + kChunkE - 1) / kChunkE : 1;
}
// Width of piece c of a row of e values: the whole row where it stays
// resident, else chunk c.
__host__ __device__ inline int piece_width(int e, int c) {
  if (!chunked(e)) return e;
  return e - c * kChunkE < kChunkE ? e - c * kChunkE : kChunkE;
}

// Bytes of a tile of `rows` rows at width e.
__host__ __device__ inline size_t tile_bytes(int rows, int e) {
  return (size_t)rows * 128 * ((padded_width(e) + 63) / 64);
}

// Bytes of a tile of `rows` rows that holds one piece of a row of e values.
__host__ __device__ inline size_t piece_bytes(int rows, int e) {
  return tile_bytes(rows, chunked(e) ? kChunkE : e);
}

// Bytes of TileWalk's ring for bq queries at width e: the resident query
// tile and two key tiles, or two stages of a (query, key) chunk pair.
__host__ __device__ inline size_t ring_bytes(int bq, int e) {
  return (chunked(e) ? 2 : 1) * piece_bytes(bq, e) +
         2 * piece_bytes(kTileN, e);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The block's dynamic shared memory, moved up to the tile alignment (the
// launch asks for kAlign bytes more than it uses).
__device__ __forceinline__ uint8_t* aligned_smem(uint8_t* raw) {
  const uint32_t a = smem_addr(raw);
  return raw + ((kAlign - (a & (kAlign - 1))) & (kAlign - 1));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's copy groups are still in flight,
// then make the landed bytes visible to the tensor cores' (async) proxy.
// A block barrier must follow before another thread's wgmma reads them.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Stage columns c0 .. c0+w-1 of rows g0 .. g0+rows-1 of a row-major (*, e)
// bf16 matrix into the tile at shared address `dst` (a tile of width w);
// rows at or past `limit` and the padding columns are zero. e % 8 == 0,
// c0 % 8 == 0 and rows are 16-byte aligned. Called by all kThreads threads
// of the block; completes at cp_async_wait.
template <int kThreads>
__device__ __forceinline__ void load_tile(const __nv_bfloat16* __restrict__ g,
                                          uint32_t dst, long long g0,
                                          int rows, long long limit, int e,
                                          int c0 = 0, int w = -1) {
  if (w < 0) w = e;
  const int chunks = padded_width(w) / 8;  // 16-byte chunks per tile row
  const int live = w / 8;
  g += c0;
  for (int t = threadIdx.x; t < rows * chunks; t += kThreads) {
    const int r = t / chunks;
    const int c = t - r * chunks;
    const bool in = g0 + r < limit && c < live;
    const __nv_bfloat16* src = in ? g + (g0 + r) * e + c * 8 : g;
    cp_async16(dst + (c >> 3) * rows * 128 + r * 128 +
                   (((c & 7) ^ (r & 7)) << 4),
               src, in ? 16 : 0);
  }
}

// load_tile for a gathered A tile: tile row r holds columns c0 .. c0+w-1
// of row ids[r] of a row-major (n_src, e) bf16 matrix for r < n_ids; a row
// whose id lies outside [0, n_src), the rows from n_ids to `rows` and the
// padding columns are zero. ids is in global memory.
template <int kThreads>
__device__ __forceinline__ void load_gathered_tile(
    const __nv_bfloat16* __restrict__ g, uint32_t dst,
    const int* __restrict__ ids, int n_ids, int rows, int n_src, int e,
    int c0 = 0, int w = -1) {
  if (w < 0) w = e;
  const int chunks = padded_width(w) / 8;
  const int live = w / 8;
  g += c0;
  for (int t = threadIdx.x; t < rows * chunks; t += kThreads) {
    const int r = t / chunks;
    const int c = t - r * chunks;
    const int id = r < n_ids ? __ldg(ids + r) : -1;
    const bool in = id >= 0 && id < n_src && c < live;
    const __nv_bfloat16* src = in ? g + (long long)id * e + c * 8 : g;
    cp_async16(dst + (c >> 3) * rows * 128 + r * 128 +
                   (((c & 7) ^ (r & 7)) << 4),
               src, in ? 16 : 0);
  }
}

// Shared-memory matrix descriptor: K-major, 128-byte swizzle, 8-row groups
// 1024 bytes apart.
__device__ __forceinline__ uint64_t descriptor(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void fence_operand(float (&d)[kAcc]) {
#pragma unroll
  for (int i = 0; i < kAcc; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[kAcc],
                                                 uint64_t da, uint64_t db,
                                                 int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d = A . B^T for the calling warpgroup (d += A . B^T with `accumulate`,
// a later chunk of a wide row): A is rows a_row0 .. a_row0+63 of the tile
// at `a` (a_rows rows in all), B the 128-row tile at `b`, over
// padded_width(e) / 16 steps of k16. All 128 threads of the warpgroup call
// it; the result is in d when it returns.
//
// Thread t of the warpgroup (warp w = t / 32, lane l) holds, for
// j = 0..15, d[4j + 2h + x] = score of A row 16w + l/4 + 8h against B row
// 8j + 2(l % 4) + x.
__device__ __forceinline__ void mma_tile(float (&d)[kAcc], uint32_t a,
                                         int a_rows, int a_row0, uint32_t b,
                                         int e, bool accumulate = false) {
  const int steps = padded_width(e) / 16;
  fence_operand(d);
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
  for (int s = 0; s < steps; ++s) {
    const uint32_t in_atom = (s & 3) * 32;  // 16 bf16 columns a step
    const uint32_t atom = s >> 2;
    wgmma_m64n128k16(
        d, descriptor(a + atom * a_rows * 128 + a_row0 * 128 + in_atom),
        descriptor(b + atom * kTileN * 128 + in_atom), s > 0 || accumulate);
  }
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  fence_operand(d);
}

// d = A . B^T over a whole row of e values, piece after piece into the same
// accumulators: the one order of k16 steps of every kernel on this tile.
// kChunk false: the row stays resident, one piece (e <= kResidentE); true:
// n_chunks(e) pieces of kChunkE columns. land(c) makes piece c's pair of
// tiles visible to the warpgroup (its copies landed, a block barrier) and
// returns their shared addresses, A's in .x and B's in .y. Arguments
// otherwise as mma_tile's.
template <bool kChunk, class Land>
__device__ __forceinline__ void mma_row(float (&d)[kAcc], int e, int a_rows,
                                        int a_row0, Land land) {
  const int n = kChunk ? n_chunks(e) : 1;
  for (int c = 0; c < n; ++c) {
    const uint2 ab = land(c);
    mma_tile(d, ab.x, a_rows, a_row0, ab.y, kChunk ? piece_width(e, c) : e,
             c > 0);
  }
}

// The walk of kernel D and of the score matrix: kBQ query rows from
// q0 against key tiles t = 0 .. n_tiles - 1 of kTileN rows from k0, in a
// ring of ring_bytes(kBQ, e) bytes of shared memory, the next piece's
// copies in flight while the current one multiplies. kChunk false (rows of
// at most kResidentE values): the query tile stays resident and piece t is
// key tile t. kChunk true: piece p = t * n_chunks(e) + c is chunk c of the
// query tile and of key tile t, in stage p % 2. Query rows at or past
// q_limit and key rows at or past k_limit are zero.
template <int kThreads, int kBQ, bool kChunk>
struct TileWalk {
  const __nv_bfloat16* q;
  const __nv_bfloat16* keys;
  long long q0, q_limit, k0, k_limit;
  int n_tiles, e, n_ch;
  uint32_t base, qb, kb;  // the ring's address, a query and a key tile's bytes

  __device__ TileWalk(uint8_t* smem, const __nv_bfloat16* q_,
                      const __nv_bfloat16* keys_, long long q0_,
                      long long q_limit_, long long k0_, long long k_limit_,
                      int n_tiles_, int e_)
      : q(q_), keys(keys_), q0(q0_), q_limit(q_limit_), k0(k0_),
        k_limit(k_limit_), n_tiles(n_tiles_), e(e_),
        n_ch(kChunk ? n_chunks(e_) : 1), base(smem_addr(smem)),
        qb((uint32_t)piece_bytes(kBQ, e_)),
        kb((uint32_t)piece_bytes(kTileN, e_)) {}

  // The query and key tiles of stage s: resident, [q][k 0][k 1]; chunked,
  // [q 0][k 0][q 1][k 1].
  __device__ uint32_t q_tile(int s) const {
    return kChunk ? base + s * (qb + kb) : base;
  }
  __device__ uint32_t k_tile(int s) const {
    return kChunk ? base + s * (qb + kb) + qb : base + qb + s * kb;
  }

  // Stage piece p, if there is one, as one copy group. All kThreads
  // threads call it.
  __device__ void issue(int p) {
    const int t = kChunk ? p / n_ch : p;
    if (t >= n_tiles) return;
    const long long r = k0 + (long long)t * kTileN;
    if (kChunk) {
      const int c = p - t * n_ch;
      const int c0 = c * kChunkE, w = piece_width(e, c);
      load_tile<kThreads>(q, q_tile(p & 1), q0, kBQ, q_limit, e, c0, w);
      load_tile<kThreads>(keys, k_tile(p & 1), r, kTileN, k_limit, e, c0, w);
    } else {
      load_tile<kThreads>(keys, k_tile(p & 1), r, kTileN, k_limit, e);
    }
    cp_async_commit();
  }

  // Stage the resident query tile, if the row stays resident, and piece 0,
  // as one copy group.
  __device__ void start() {
    if (n_tiles <= 0) return;
    if (!kChunk) load_tile<kThreads>(q, q_tile(0), q0, kBQ, q_limit, e);
    issue(0);
  }

  // Wait for piece p's copies, then a block barrier: every warp is done
  // with the piece before, whose stage then takes piece p + 1.
  __device__ void land(int p) {
    cp_async_wait<0>();
    __syncthreads();
    issue(p + 1);
  }

  // Land key tile t's first piece. All threads of the block call it for
  // t = 0, 1, ... in turn, after start(), each time before product(t).
  __device__ void begin(int t) { land(t * n_ch); }

  // d = the scores of query rows a_row0 .. a_row0 + 63 of the tile against
  // key tile t, landing its further pieces as it goes.
  __device__ void product(float (&d)[kAcc], int t, int a_row0) {
    mma_row<kChunk>(d, e, kBQ, a_row0, [&](int c) {
      const int p = t * n_ch + c;
      if (c > 0) land(p);
      return make_uint2(q_tile(p & 1), k_tile(p & 1));
    });
  }
};

}  // namespace rgm
