// Edge-dropout keep mask and per-edge weights of both edge orders in one
// pass (rg_edge_weights).
//
// Replaces no Pallas kernel. The JAX package writes the dropout hash
// (hash_edge_mask, ragraph_tpu/models/edge/base.py) and the weight fold of
// TemporalLightGCN._edge_weights as array code, which XLA fuses into one
// loop on the TPU. In PyTorch the same code is one kernel per operation:
// torch has no uint32 multiply, so each hash is about 35 full-length int64
// passes, twice a step (receiver and sender order), then the fold and the
// mask in both orders; about 80 launches and 23 GB of traffic a step at
// Taobao's 17.6M directed edges.
//
// Per edge i of n, in each order:
//   keep = AND over the draws (salt_d, thresh_d) of  h(id, salt_d) < thresh_d
//   w    = en * 0.5 + tn * c   with the time fold, else en
//   out  = keep ? w : +0.0
// h is hash_edge_mask's murmur3-style finalizer in native uint32
// arithmetic; id is i in receiver order and send_perm[i] in sender order.
// The fold rounds the product and the sum apart (__fmul_rn, __fadd_rn), as
// the three PyTorch operations it replaces round them: no contracted FMA,
// so the weights are bit for bit the composition's. c is 0.5 * time_scale
// rounded to f32 by the caller, as PyTorch rounds a scalar operand.
//
// What bounds it on an H100: bytes. Per directed edge, 4 bytes of edge_norm,
// 4 of time_norm and 4 of weight out in each order, plus 4 of send_perm:
// 28 bytes, 0.49 GB at 17.6M edges, 0.147 ms at 3.35 TB/s. The hash is
// about a dozen integer operations an edge, far below that.
//
// Design: one pass, no intermediate in device memory. A thread takes four
// consecutive edges in both orders: 16-byte loads of the norms and the
// permutation and 16-byte stores of the weights where every pointer is
// 16-byte aligned, 4-byte accesses otherwise and for the last n % 4 edges.
// The salts are read on the device from the 0-d tensors the generator drew
// (never on the host), once a thread, so the launch queues behind the draw
// with no synchronisation.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxDraws = 2;

struct Draws {
  const long long* salt[kMaxDraws];
  unsigned int thresh[kMaxDraws];
  int n;
};

// One order's arrays. tn is null without the time fold, perm null in
// receiver order (the id is the position).
struct Order {
  const float* en;
  const float* tn;
  const int* perm;
  float* out;
};

__device__ __forceinline__ uint32_t edge_hash(uint32_t id, uint32_t salt) {
  uint32_t x = id * 0x9E3779B9u + salt;
  x = (x ^ (x >> 16)) * 0x85EBCA6Bu;
  x = (x ^ (x >> 13)) * 0xC2B2AE35u;
  return x ^ (x >> 16);
}

__device__ __forceinline__ float weight(uint32_t id, float en, float tn,
                                        bool fold, float c,
                                        const uint32_t (&salt)[kMaxDraws],
                                        const Draws& d) {
  bool keep = true;
#pragma unroll
  for (int k = 0; k < kMaxDraws; ++k)
    if (k < d.n) keep = keep && edge_hash(id, salt[k]) < d.thresh[k];
  const float w = fold ? __fadd_rn(__fmul_rn(en, 0.5f), __fmul_rn(tn, c)) : en;
  return keep ? w : 0.0f;
}

// Edges 4v .. 4v + 3 of one order, 16-byte accesses.
__device__ __forceinline__ void four(const Order& o, long long v, float c,
                                     const uint32_t (&salt)[kMaxDraws],
                                     const Draws& d) {
  const bool fold = o.tn != nullptr;
  const float4 en = __ldg(reinterpret_cast<const float4*>(o.en) + v);
  const float4 tn = fold ? __ldg(reinterpret_cast<const float4*>(o.tn) + v)
                         : make_float4(0.f, 0.f, 0.f, 0.f);
  uint32_t id[4];
  if (o.perm != nullptr) {
    const int4 p = __ldg(reinterpret_cast<const int4*>(o.perm) + v);
    id[0] = (uint32_t)p.x; id[1] = (uint32_t)p.y;
    id[2] = (uint32_t)p.z; id[3] = (uint32_t)p.w;
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) id[j] = (uint32_t)(4 * v + j);
  }
  float4 w;
  w.x = weight(id[0], en.x, tn.x, fold, c, salt, d);
  w.y = weight(id[1], en.y, tn.y, fold, c, salt, d);
  w.z = weight(id[2], en.z, tn.z, fold, c, salt, d);
  w.w = weight(id[3], en.w, tn.w, fold, c, salt, d);
  reinterpret_cast<float4*>(o.out)[v] = w;
}

// Edge i of one order, 4-byte accesses.
__device__ __forceinline__ void one(const Order& o, long long i, float c,
                                    const uint32_t (&salt)[kMaxDraws],
                                    const Draws& d) {
  const bool fold = o.tn != nullptr;
  const uint32_t id = o.perm != nullptr ? (uint32_t)__ldg(o.perm + i)
                                        : (uint32_t)i;
  o.out[i] = weight(id, __ldg(o.en + i), fold ? __ldg(o.tn + i) : 0.f, fold,
                    c, salt, d);
}

// recv always; send where send.out is set. With `vec`, threads take the
// first n / 4 groups of four, then the last n % 4 edges one each.
__global__ void __launch_bounds__(kThreads)
edge_weights_kernel(Order recv, Order send, Draws d, float c, long long n,
                    int vec) {
  uint32_t salt[kMaxDraws];
#pragma unroll
  for (int k = 0; k < kMaxDraws; ++k)
    salt[k] = k < d.n ? (uint32_t)(unsigned long long)__ldg(d.salt[k]) : 0u;
  const bool both = send.out != nullptr;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long first = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long groups = vec ? n / 4 : 0;
  for (long long v = first; v < groups; v += stride) {
    four(recv, v, c, salt, d);
    if (both) four(send, v, c, salt, d);
  }
  for (long long i = 4 * groups + first; i < n; i += stride) {
    one(recv, i, c, salt, d);
    if (both) one(send, i, c, salt, d);
  }
}

bool aligned16(const void* p) {
  return p == nullptr || (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

extern "C" {

// en, tn: receiver-order f32 edge norms and time softmax (tn null: no time
// fold); en_s, tn_s, perm: the same in sender order and send_perm (int32),
// read only where out_s is set; salt0, salt1: 0-d int64 device tensors whose
// low 32 bits are the draws' salts, thresh0, thresh1 their keep thresholds
// in [0, 2^32), the first n_draws (0 to 2) of them ANDed; c: the fold's time
// coefficient; out, out_s: f32 weights in receiver and sender order (out_s
// null: receiver order only); n edges.
int rg_edge_weights(const void* en, const void* tn, const void* en_s,
                    const void* tn_s, const void* perm, const void* salt0,
                    const void* salt1, long long thresh0, long long thresh1,
                    int n_draws, float c, void* out, void* out_s, long long n,
                    void* stream) {
  if (n_draws < 0 || n_draws > kMaxDraws || n < 0
      || (out_s != nullptr && (en_s == nullptr || perm == nullptr
                               || (tn != nullptr && tn_s == nullptr))))
    return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  Draws d;
  d.salt[0] = static_cast<const long long*>(salt0);
  d.salt[1] = static_cast<const long long*>(salt1);
  d.thresh[0] = (unsigned int)thresh0;
  d.thresh[1] = (unsigned int)thresh1;
  d.n = n_draws;
  const Order recv{static_cast<const float*>(en), static_cast<const float*>(tn),
                   nullptr, static_cast<float*>(out)};
  const Order send{static_cast<const float*>(en_s),
                   out_s != nullptr && tn != nullptr
                       ? static_cast<const float*>(tn_s) : nullptr,
                   static_cast<const int*>(perm), static_cast<float*>(out_s)};
  const int vec = aligned16(en) && aligned16(tn) && aligned16(out)
                  && (out_s == nullptr
                      || (aligned16(en_s) && aligned16(send.tn)
                          && aligned16(perm) && aligned16(out_s)));
  const long long items = vec ? (n + 3) / 4 : n;
  const long long blocks = (items + kThreads - 1) / kThreads;
  const unsigned grid = (unsigned)(blocks < (1LL << 20) ? blocks : (1LL << 20));
  edge_weights_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      recv, send, d, c, n, vec);
  return (int)cudaGetLastError();
}

}  // extern "C"
