// Shared pieces of the bucket kernels D-G (bucket_topk.cu): the f32 tile
// loader and the one dot-product order D and F use; and the constants of
// every retrieval kernel (C and J, on the tensor cores, use rg_mma.cuh).
//
// Every score in D and F is sum_c q[c] * key[c] over bf16 inputs. A product
// of two bf16 values is exact in f32, so a score depends only on the order
// of the f32 additions. D and F add in ascending c into one accumulator
// that starts at 0 (fma4 below, called for c = 0, 4, 8, ...), as the plain
// versions do (_fma_chain in ops/bucket_topk.py). Kernel D's bucket maxima
// are therefore bitwise the scores kernel F returns. Kernels C and J add
// the same products in the tensor cores' order: within a few f32 roundings
// of these scores, not bitwise.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace rg {

constexpr unsigned kFull = 0xffffffffu;
constexpr float kNegInf = -3.0e38f;

// acc += a . b over four consecutive columns, in ascending column order.
__device__ __forceinline__ void fma4(float& acc, const float4& a,
                                     const float4& b) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  acc = fmaf(a.w, b.w, acc);
}

// Eight consecutive bf16 values (16-byte aligned) to eight f32 values in
// shared memory (16-byte aligned); a null source stores zeros.
__device__ __forceinline__ void load8(const __nv_bfloat16* __restrict__ src,
                                      float* dst) {
  float4 lo = make_float4(0.f, 0.f, 0.f, 0.f), hi = lo;
  if (src != nullptr) {
    const uint4 raw = *reinterpret_cast<const uint4*>(src);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
    const float2 a = __bfloat1622float2(h[0]);
    const float2 b = __bfloat1622float2(h[1]);
    const float2 c = __bfloat1622float2(h[2]);
    const float2 d = __bfloat1622float2(h[3]);
    lo = make_float4(a.x, a.y, b.x, b.y);
    hi = make_float4(c.x, c.y, d.x, d.y);
  }
  *reinterpret_cast<float4*>(dst) = lo;
  *reinterpret_cast<float4*>(dst + 4) = hi;
}

// Load `rows` rows of E bf16 values (starting at global row g0, rows at or
// past `limit` read as zero) into f32 shared memory with row stride E + 4.
// E is a multiple of 8 and the rows are 16-byte aligned. Called by all
// kThreads threads of the block.
template <int kThreads>
__device__ __forceinline__ void load_rows(const __nv_bfloat16* __restrict__ g,
                                          float* s, long long g0, int rows,
                                          long long limit, int e) {
  const int chunks = e / 8;
  const int ld = e + 4;
  for (int t = threadIdx.x; t < rows * chunks; t += kThreads) {
    const int r = t / chunks;
    const int c = t - r * chunks;
    load8(g0 + r < limit ? g + (g0 + r) * e + c * 8 : nullptr,
          s + r * ld + c * 8);
  }
}

}  // namespace rg
